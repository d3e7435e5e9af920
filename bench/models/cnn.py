"""Driver of the paper's CNNs: the port's dispatcher entry point
``repro_torch.models.cnn.cnn_forward`` over a pool of frame batches.

The configuration file gives the network (``input_hw``, ``cin``,
``layers``, ``num_classes``, ``tile``) and its ``dtype``.  The weights and
the frames are drawn here from the seed, on the card, each in one call;
the program gets them as they are.  Counts of work come from the layer
shapes alone.
"""

from __future__ import annotations

import math
from types import ModuleType

import torch

from benchkit.cell import Setup
from benchkit.peaks import roofline_s
from benchkit.rounding import ROUNDINGS

__all__ = ["layer_shapes", "gemms", "model_flops", "gemm_bound_s",
           "make_weights", "setup"]

_BIAS_SCALE = 0.05
_BYTES = {"float32": 4}


def layer_shapes(config: dict) -> list[tuple]:
    """(spec, h, w, c) before each layer."""
    h = w = config["input_hw"]
    c = config["cin"]
    out = []
    for spec in map(tuple, config["layers"]):
        out.append((spec, h, w, c))
        if spec[0] == "conv":
            _, cout, k, s, p = spec
            h, w, c = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, cout
        elif spec[0] == "pool":
            h, w = h // spec[1], w // spec[1]
        elif spec[0] == "fc":
            h, w, c = 1, 1, spec[1]
    return out


def gemms(config: dict, batch: int) -> list[tuple[str, int, int, int]]:
    """(layer, m, n, k) of each CONV (im2col) and FC GEMM of a batch."""
    out = []
    for i, (spec, h, w, c) in enumerate(layer_shapes(config)):
        if spec[0] == "conv":
            _, cout, k, s, p = spec
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            out.append((f"conv{i}", batch * oh * ow, cout, k * k * c))
        elif spec[0] == "fc":
            out.append((f"fc{i}", batch, spec[1], h * w * c))
    return out


def model_flops(config: dict, traffic: dict) -> float:
    """Operations of one batch: 2·m·n·k over its GEMMs."""
    return float(sum(2 * m * n * k
                     for _, m, n, k in gemms(config, traffic["batch"])))


def gemm_bound_s(config: dict, traffic: dict) -> float:
    """The least time of a batch's GEMMs: each at the larger of its
    operations over the dtype's peak and its bytes (A, B and the bias read
    once, C written once) over the memory's bandwidth."""
    e = _BYTES[config["dtype"]]
    return sum(roofline_s(2 * m * n * k, e * (m * k + k * n + n + m * n),
                          config["dtype"])
               for _, m, n, k in gemms(config, traffic["batch"]))


def make_weights(config: dict, g: torch.Generator,
                 device: torch.device) -> dict:
    """He-normal weights and small normal biases, keyed and laid out as
    ``repro_torch.models.cnn.init_cnn``'s (``conv{i}_w`` (kh, kw, cin,
    cout), ``fc{i}_w`` (n_in, n_out)), drawn in one call."""
    leaves = []
    for i, (spec, h, w, c) in enumerate(layer_shapes(config)):
        if spec[0] == "conv":
            _, cout, k, _, _ = spec
            leaves += [(f"conv{i}_w", (k, k, c, cout),
                        math.sqrt(2.0 / (k * k * c))),
                       (f"conv{i}_b", (cout,), _BIAS_SCALE)]
        elif spec[0] == "fc":
            n_in = h * w * c
            leaves += [(f"fc{i}_w", (n_in, spec[1]), math.sqrt(2.0 / n_in)),
                       (f"fc{i}_b", (spec[1],), _BIAS_SCALE)]
    dtype = getattr(torch, config["dtype"])
    flat = torch.randn(sum(math.prod(s) for _, s, _ in leaves),
                       generator=g, device=device, dtype=dtype)
    params, at = {}, 0
    for name, shape, scale in leaves:
        n = math.prod(shape)
        params[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    return params


def setup(config: dict, traffic: dict, seed: int, device: torch.device,
          reference: ModuleType) -> Setup:
    """``reference`` is the cell's plain reference (``logits``), which the
    check and the control run."""
    from repro_torch.models.cnn import CNNConfig, cnn_forward
    g = torch.Generator(device=device).manual_seed(seed)
    params = make_weights(config, g, device)
    hw, cin = config["input_hw"], config["cin"]
    frames = torch.randn((traffic["pool"], traffic["batch"], hw, hw, cin),
                         generator=g, device=device,
                         dtype=getattr(torch, config["dtype"]))
    arch = CNNConfig(name=config["name"], input_hw=hw, cin=cin,
                     layers=tuple(map(tuple, config["layers"])),
                     num_classes=config["num_classes"], tile=config["tile"])
    kwargs = traffic.get("entry", {})
    layers = [tuple(s) for s in config["layers"]]

    def entry(i: int) -> torch.Tensor:
        return cnn_forward(arch, params, frames[i], device=device, **kwargs)

    def check(batches: list) -> dict[str, float]:
        """``logits_err``: over every batch of the window, the largest
        gap between a logit and the reference's, over the reference's
        largest logit of that batch."""
        worst = 0.0
        for i in sorted({b.index for b in batches}):
            ref = reference.logits(layers, params, frames[i])
            outs = torch.stack([b.output for b in batches if b.index == i])
            err = (outs.to(torch.float32) - ref).abs().amax().item()
            worst = max(worst, err / ref.abs().amax().item())
        return {"logits_err": worst}

    def control(rounding: str):
        cast = ROUNDINGS[rounding]
        return lambda i: reference.logits(layers, params, frames[i],
                                          cast=cast)

    return Setup(entry=entry, answer=lambda out: out.argmax(dim=-1),
                 counts={"frames": traffic["batch"],
                         "requests": traffic["batch"]},
                 check=check, control=control)
