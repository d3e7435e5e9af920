"""The yardstick's counts of work, against counts made by hand from the
published widths, and the control's rounding."""

import json

import pytest

import bench_testkit as tk
from benchkit.manifest import load_module

CNN = load_module(tk.BENCH / "models" / "cnn.py", "bench_model")
ALEX = json.loads((tk.BENCH / "configs/cifar_alex_plus.json").read_text())


def test_cifar_alex_plus_flops_a_frame():
    # conv0 32x32 out, k 5*5*3, 64; conv2 16x16, k 5*5*64, 64; conv4 8x8,
    # k 5*5*64, 128; fc6 4*4*128 -> 128; fc7 128 -> 10
    hand = 2 * (1024 * 75 * 64 + 256 * 1600 * 64 + 64 * 1600 * 128
                + 2048 * 128 + 128 * 10)
    assert hand == 89_000_448
    assert CNN.model_flops(ALEX, {"batch": 1}) == hand
    assert CNN.model_flops(ALEX, {"batch": 256}) == 256 * hand


def test_cifar_alex_plus_gemm_bound():
    """conv0 by its bytes (A 256·1024 x 75, C x 64, fp32), the rest by
    their operations at 67 TFLOP/s."""
    conv0 = 4 * (262144 * 75 + 75 * 64 + 64 + 262144 * 64) / 3.35e12
    ops = 2 * 256 * (256 * 1600 * 64 + 64 * 1600 * 128 + 2048 * 128
                     + 128 * 10) / 67e12
    assert CNN.gemm_bound_s(ALEX, {"batch": 256}) == pytest.approx(
        conv0 + ops, rel=1e-3)
    assert CNN.gemm_bound_s(ALEX, {"batch": 256}) == pytest.approx(
        0.346e-3, rel=5e-3)


def test_the_weights_are_the_port_s_tree():
    """The driver's leaves have the names and shapes of
    ``repro_torch.models.cnn.init_cnn``'s, so the program runs on them as
    they are."""
    import torch

    from repro_torch.models.cnn import CNNConfig, init_cnn
    arch = CNNConfig(name="x", input_hw=ALEX["input_hw"], cin=ALEX["cin"],
                     layers=tuple(map(tuple, ALEX["layers"])),
                     num_classes=ALEX["num_classes"], tile=ALEX["tile"])
    mine = CNN.make_weights(ALEX, torch.Generator().manual_seed(1),
                            torch.device("cpu"))
    port = init_cnn(arch, torch.Generator().manual_seed(1), device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in port.items()}


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -12, 1.0),                   # under half a step: down
    (1.0 + 2.0 ** -11 + 2.0 ** -13, 1.0 + 2.0 ** -10),   # over half: up
    (1.0 + 2.0 ** -11, 1.0),                   # a tie: to the even 1.0
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),   # a tie: to the even step
    (-3.0, -3.0),
])
def test_round_tf32_keeps_ten_mantissa_bits(x, want):
    import torch

    from benchkit.rounding import round_tf32
    assert round_tf32(torch.tensor([x])).item() == want

