"""The paper's seven benchmark CNNs (Table 2), modeled from their
Darknet/Caffe training configs.  Per-frame op counts match the paper's
reported GOPS-at-fps (Table 4) to within ~10-20%:

  MNIST  ~23 MOP/frame (paper: 2.15 GOPS @ 96.2 fps -> 22.3 MOP)
  CIFAR_full ~25 MOP/frame (paper: 1.67 GOPS @ 63.5 fps -> 26.3 MOP)
"""

from __future__ import annotations

from repro_torch.models.cnn import CNNConfig

# ("conv", cout, k, stride, pad) | ("pool", size) | ("fc", n)

MNIST = CNNConfig(
    name="MNIST", input_hw=28, cin=1, layers=(
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("fc", 256), ("fc", 10),
    ))

CIFAR_FULL = CNNConfig(
    name="CIFAR_full", input_hw=32, cin=3, layers=(
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("fc", 10),
    ))

CIFAR_ALEX = CNNConfig(
    name="CIFAR_Alex", input_hw=32, cin=3, layers=(
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("fc", 64), ("fc", 10),
    ))

CIFAR_ALEX_PLUS = CNNConfig(
    name="CIFAR_Alex+", input_hw=32, cin=3, layers=(
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("conv", 128, 5, 1, 2), ("pool", 2),
        ("fc", 128), ("fc", 10),
    ))

CIFAR_DARKNET = CNNConfig(
    name="CIFAR_Darknet", input_hw=32, cin=3, layers=(
        ("conv", 32, 3, 1, 1), ("pool", 2),
        ("conv", 64, 3, 1, 1), ("pool", 2),
        ("conv", 128, 3, 1, 1),
        ("conv", 128, 3, 1, 1), ("pool", 2),
        ("fc", 10),
    ))

SVHN = CNNConfig(
    name="SVHN", input_hw=32, cin=3, layers=(
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("fc", 128), ("fc", 10),
    ))

MPCNN = CNNConfig(
    name="MPCNN", input_hw=32, cin=1, layers=(
        ("conv", 16, 5, 1, 2), ("pool", 2),
        ("conv", 32, 5, 1, 2), ("pool", 2),
        ("conv", 64, 5, 1, 2), ("pool", 2),
        ("fc", 64), ("fc", 10),
    ))

PAPER_CNNS = {c.name: c for c in (
    CIFAR_DARKNET, CIFAR_ALEX, CIFAR_ALEX_PLUS, CIFAR_FULL,
    MNIST, SVHN, MPCNN)}
