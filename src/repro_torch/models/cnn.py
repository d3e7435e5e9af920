"""CNNs via conv-as-tiled-GEMM — the paper's own benchmark networks.

Every CONV layer lowers to im2col + :func:`synergy_matmul` (so its tile-job
decomposition is visible to the schedulers), and so does every FC layer;
pooling stays on the "CPU side" as in the paper (§3.1.4).  Activations are
NHWC throughout and the FC flatten is (h, w, c), as in ``repro``.

Layer dims are modeled from the Darknet/Caffe configs the paper trained
(Table 2).  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; without a card they raise rather than run on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.im2col import conv_out_shape, im2col, im2col_wave
from repro_torch.core.job import JobSet
from repro_torch.core.scheduler import SimLayer, SimNet
from repro_torch.core.synergy_mm import synergy_matmul
from repro_torch.device import resolve_device
from repro_torch.models.params import tensor_from_numpy
from repro_torch.soc.graph import GraphNode
from repro_torch.soc.runtime import runtime_scope

__all__ = ["CNNConfig", "init_cnn", "params_from_jax", "cnn_forward",
           "conv_jobsets", "conv_graph_steps", "conv_wave_graph",
           "maxpool2d", "cnn_flops_per_frame", "build_simnet"]


def maxpool2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Non-overlapping max pool (stride == size), cropping odd edges —
    the paper's CPU-side pooling (§3.1.4)."""
    n, h, w, c = x.shape
    x = x[:, : h - h % size, : w - w % size, :]
    return x.reshape(n, h // size, size, w // size, size, c).amax(dim=(2, 4))

# layer spec forms:
#   ("conv", cout, k, stride, pad)
#   ("pool", size)           max pool, stride == size
#   ("fc", n_out)
Layer = tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    cin: int
    layers: tuple[Layer, ...]
    num_classes: int = 10
    tile: int = 32            # the paper's TS=32

    def trace_shapes(self):
        """Walk the net, yielding (layer, h, w, c_in) before each layer."""
        h = w = self.input_hw
        c = self.cin
        out = []
        for spec in self.layers:
            out.append((spec, h, w, c))
            if spec[0] == "conv":
                _, cout, k, s, p = spec
                h, w = conv_out_shape(h, w, k, k, s, p)
                c = cout
            elif spec[0] == "pool":
                size = spec[1]
                h, w = h // size, w // size
            elif spec[0] == "fc":
                h = w = 1
                c = spec[1]
        return out, (h, w, c)


def init_cnn(cfg: CNNConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: str | torch.device | None = None) -> dict:
    """He-normal weights drawn from ``generator``, zero biases, on
    ``device``.  Keys and layouts are ``repro``'s: ``conv{i}_w`` is
    (kh, kw, cin, cout), ``fc{i}_w`` is (n_in, n_out)."""
    dev = resolve_device(device)
    params = {}
    shapes, _ = cfg.trace_shapes()

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    for i, (spec, h, w, c) in enumerate(shapes):
        if spec[0] == "conv":
            _, cout, k, s, p = spec
            params[f"conv{i}_w"] = normal((k, k, c, cout),
                                          (2.0 / (k * k * c)) ** 0.5)
            params[f"conv{i}_b"] = torch.zeros((cout,), dtype=dtype,
                                               device=dev)
        elif spec[0] == "fc":
            n_in = h * w * c
            params[f"fc{i}_w"] = normal((n_in, spec[1]), (2.0 / n_in) ** 0.5)
            params[f"fc{i}_b"] = torch.zeros((spec[1],), dtype=dtype,
                                             device=dev)
    return params


def params_from_jax(np_params: dict[str, np.ndarray],
                    device: str | torch.device | None = None) -> dict:
    """Parameters of ``repro.models.cnn.init_cnn``, handed over as numpy
    arrays, as tensors on ``device`` with the same keys and layouts."""
    dev = resolve_device(device)
    return {name: tensor_from_numpy(v, dev) for name, v in np_params.items()}


def _conv_via_jobs(x, w, b, stride, pad, tile, name, engine=None,
                   job_class=None):
    """CONV -> im2col -> synergy_matmul (tile jobs) -> bias+relu epilogue."""
    kh, kw, cin, cout = w.shape
    n, h, wd, _ = x.shape
    oh, ow = conv_out_shape(h, wd, kh, kw, stride, pad)
    a = im2col(x, kh, kw, stride, pad).reshape(n * oh * ow, kh * kw * cin)
    y = synergy_matmul(a, w.reshape(-1, cout), bias=b,
                       activation=torch.relu, tile=tile, name=name,
                       engine=engine, job_class=job_class)
    return y.reshape(n, oh, ow, cout)


def cnn_forward(cfg: CNNConfig, params: dict, x: torch.Tensor, *,
                engine: str | None = None,
                job_class: str | None = None,
                runtime=None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """x: (N, H, W, Cin) -> logits (N, num_classes), run on ``device``
    (default the card) under ``torch.inference_mode``.

    ``engine``: pin every GEMM to a registered engine; None lets the
    dispatcher rank capable engines per GEMM (the default).
    ``job_class``: precision-routing policy for every GEMM
    (:data:`repro_torch.engines.JOB_CLASSES`).
    ``runtime``: a :class:`repro_torch.soc.SynergyRuntime` on the same
    device — every CONV/FC GEMM is split into row panels across its
    engine pool and balanced by work stealing (with ``engine`` demoted to
    a queue-affinity hint).  ``params`` must already live on ``device``;
    ``x`` is moved there."""
    dev = resolve_device(device)
    for name, p in params.items():
        if p.device.type != dev.type:
            raise ValueError(f"param {name!r} is on {p.device}, the forward "
                             f"runs on {dev}")
    scope = (runtime_scope(runtime) if runtime is not None
             else contextlib.nullcontext())
    with scope, torch.inference_mode():
        x = x.to(dev)
        shapes, _ = cfg.trace_shapes()
        for i, (spec, *_rest) in enumerate(shapes):
            if spec[0] == "conv":
                _, cout, k, s, p = spec
                x = _conv_via_jobs(x, params[f"conv{i}_w"],
                                   params[f"conv{i}_b"], s, p, cfg.tile,
                                   f"{cfg.name}/conv{i}", engine=engine,
                                   job_class=job_class)
            elif spec[0] == "pool":
                x = maxpool2d(x, spec[1])
            elif spec[0] == "fc":
                x = x.reshape(x.shape[0], -1)
                last = all(s2[0] != "fc" for s2, *_ in shapes[i + 1:])
                x = synergy_matmul(x, params[f"fc{i}_w"],
                                   bias=params[f"fc{i}_b"],
                                   activation=None if last else torch.relu,
                                   tile=cfg.tile, name=f"{cfg.name}/fc{i}",
                                   engine=engine, job_class=job_class)
        return x


def cnn_flops_per_frame(cfg: CNNConfig) -> int:
    total = 0
    shapes, _ = cfg.trace_shapes()
    for spec, h, w, c in shapes:
        if spec[0] == "conv":
            _, cout, k, s, p = spec
            oh, ow = conv_out_shape(h, w, k, k, s, p)
            total += 2 * oh * ow * cout * k * k * c
        elif spec[0] == "fc":
            total += 2 * h * w * c * spec[1]
    return total


def conv_jobsets(cfg: CNNConfig, n_frames: int = 1, *,
                 tile: int | tuple | None = None,
                 name_prefix: str = "") -> list[tuple[int, JobSet]]:
    """The per-CONV-layer im2col GEMM JobSets of an ``n_frames`` image
    batch: ``[(layer_index, JobSet), ...]`` in network order — the one
    conv-as-GEMM shape source for the simulator and serving accounting."""
    out: list[tuple[int, JobSet]] = []
    shapes, _ = cfg.trace_shapes()
    conv_id = 0
    for i, (spec, h, w, c) in enumerate(shapes):
        if spec[0] != "conv":
            continue
        _, cout, k, s, p = spec
        js = JobSet.for_conv(conv_id, n_frames, h, w, c, cout, k, s, p,
                             tile if tile is not None else cfg.tile,
                             name=f"{name_prefix}{cfg.name}/conv{i}")
        out.append((i, js))
        conv_id += 1
    return out


def conv_graph_steps(cfg: CNNConfig) -> list[tuple]:
    """Per-CONV-layer dataflow geometry for graph construction:
    ``[(layer_index, pools_before, (k, stride, pad), (oh, ow, cout)),
    ...]`` in network order, where ``pools_before`` are the CPU-side max
    pool sizes between the previous conv and this one.  The conv
    front-end ends at the first FC layer (matching the serving prefill
    chain)."""
    out: list[tuple] = []
    shapes, _ = cfg.trace_shapes()
    pools: list[int] = []
    for i, (spec, h, w, c) in enumerate(shapes):
        if spec[0] == "pool":
            pools.append(spec[1])
        elif spec[0] == "conv":
            _, cout, k, s, p = spec
            oh, ow = conv_out_shape(h, w, k, k, s, p)
            out.append((i, tuple(pools), (k, s, p), (oh, ow, cout)))
            pools = []
        else:                         # fc: conv front-end ends here
            break
    return out


def conv_wave_graph(cfg: CNNConfig, params: dict, x0: torch.Tensor,
                    steps: Sequence[tuple], jobsets: Sequence[JobSet],
                    n_frames: int, *, in_shape: tuple | None = None,
                    affinity: str | None = None,
                    job_class: str | None = "prefill",
                    im2col_fn=None, qos=None):
    """Build the ``(nodes, edges)`` dataflow graph of one prefill wave's
    conv front-end over a consecutive slice of :func:`conv_graph_steps`.

    Layer *l* becomes two nodes: a HOST gather node (reshape the previous
    GEMM's flat output, apply the CPU-side pools, one
    :func:`~repro_torch.core.im2col.im2col_wave` over the whole wave) and
    a GEMM node (``submit_gemm`` of the im2col panel against the conv
    weights) — so layer *l+1*'s gather overlaps layer *l*'s GEMM compute,
    the NEURAghe-style producer/consumer overlap the chain never had.

    ``x0``: the slice's input — the stacked wave frames for the first
    chunk, or the previous chunk's flat GEMM output (then pass
    ``in_shape`` to restore (N, H, W, C)); it and ``params`` live on the
    runtime's device, where the gathers run too.  The LAST node's value
    is the final conv's flat ``(m, cout)`` output.  ``im2col_fn``
    overrides the gather primitive (a caller passes its own module
    reference so instrumentation hooks on that module see every wave
    gather); ``qos`` attaches a :class:`repro_torch.soc.qos_policy.QosTag`
    to every GEMM node's panels, so a chunked prefill wave schedules at
    its tenants' class and decode-class work preempts it at chunk
    boundaries."""
    if im2col_fn is None:
        im2col_fn = im2col_wave

    nodes: list = []
    edges: list[tuple[int, int]] = []
    prev_gemm: int | None = None
    prev_shape = in_shape
    for (i, pools, (k, s, p), (oh, ow, cout)), js in zip(steps, jobsets):

        def gather(rt, *pred, _pools=pools, _k=k, _s=s, _p=p,
                   _shape=prev_shape):
            x = pred[0].reshape(_shape) if pred else (
                x0.reshape(_shape) if _shape is not None else x0)
            for size in _pools:
                x = maxpool2d(x, size)
            return im2col_fn(x, _k, _k, _s, _p)

        def gemm(rt, a, _i=i, _js=js, _cout=cout):
            return rt.submit_gemm(
                a, params[f"conv{_i}_w"].reshape(-1, _cout), jobset=_js,
                bias=params[f"conv{_i}_b"], activation=torch.relu,
                tile=(_js.ts_m, _js.ts_n, _js.ts_k), job_class=job_class,
                affinity=affinity, qos=qos)

        gi = len(nodes)
        nodes.append(GraphNode(name=f"{js.name}/gather", run=gather))
        if prev_gemm is not None:
            edges.append((prev_gemm, gi))
        nodes.append(GraphNode(name=js.name, run=gemm))
        edges.append((gi, gi + 1))
        prev_gemm = gi + 1
        prev_shape = (n_frames, oh, ow, cout)
    return nodes, edges


def build_simnet(cfg: CNNConfig) -> SimNet:
    """Export as a SimNet for the discrete-event runtime simulator.

    CONV layers -> accelerated tile-job stages (+ im2col CPU cost);
    pool/fc -> CPU stages; plus the paper's normalization preprocessing."""
    layers: list[SimLayer] = []
    shapes, _ = cfg.trace_shapes()
    # normalization / scaling preprocessing (§3.1.4)
    n_in_elems = cfg.input_hw * cfg.input_hw * cfg.cin
    layers.append(SimLayer("norm", "cpu", cpu_ops=4 * n_in_elems))
    # DES layer names are bare conv{i} (no net prefix): keep them stable
    conv_js = {i: dataclasses.replace(js, name=f"conv{i}")
               for i, js in conv_jobsets(cfg)}
    for i, (spec, h, w, c) in enumerate(shapes):
        if spec[0] == "conv":
            js = conv_js[i]
            # im2col writes m*k floats (fp32), reads input once
            layers.append(SimLayer(f"conv{i}", "conv", jobset=js,
                                   im2col_bytes=4 * (js.m * js.k
                                                     + h * w * c)))
        elif spec[0] == "pool":
            size = spec[1]
            layers.append(SimLayer(f"pool{i}", "cpu",
                                   cpu_ops=h * w * c))
        elif spec[0] == "fc":
            layers.append(SimLayer(f"fc{i}", "cpu",
                                   cpu_ops=2 * h * w * c * spec[1]))
    return SimNet(cfg.name, tuple(layers))
