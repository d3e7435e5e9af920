"""Cross-pod local SGD with compressed delta synchronization.

The inter-pod links are the slowest fabric in a multi-pod job, and the
per-step gradient all-reduce crosses them 100s of times per second.  Local
SGD (a.k.a. periodic parameter averaging) trains each pod's DP group
independently for ``sync_every`` steps, then averages PARAMETER DELTAS
across pods — with blockwise-int8 compression + error feedback
(``repro_torch.optim.compress``), cutting cross-pod traffic by
~4x * sync_every compared to per-step fp32 gradient all-reduce.

Each rank calls :func:`sync_pods_compressed` with its own pod's tensors;
the pods meet in one all-reduce per leaf over the mesh's 'pod' axis
(``repro``'s ``pmean`` inside ``shard_map``: a SUM over the pod group
divided by its size, as gloo has no AVG).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import scalar
from repro_torch.optim.compress import dequantize_int8, quantize_int8
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["sync_pods_compressed", "crosspod_traffic_bytes"]


def sync_pods_compressed(params, anchor, err, *, mesh,
                         axis_name: str = "pod"):
    """On every rank of ``mesh``: average each pod's drift from the shared
    anchor over ``axis_name``, int8-compressed, with error feedback.

    params: this pod's params; anchor: params at last sync (identical
    across pods); err: error-feedback state.  Returns (new params, new
    anchor, new err)."""
    group = mesh.get_group(axis_name)
    n_pods = dist.get_world_size(group)

    def sync_leaf(p, a, e):
        delta = (p - a).to(torch.float32) + e
        q, scale, pad = quantize_int8(delta)
        deq = dequantize_int8(q, scale, pad, p.shape)
        new_e = delta - deq
        # the all-reduce moves int8+scales in a real fabric; numerically we
        # average the dequantized deltas (bit-identical to decompress-sum)
        total = deq.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean_delta = total / scalar(n_pods, total)
        new_p = (a.to(torch.float32) + mean_delta).to(p.dtype)
        return new_p, new_e

    out = tree_map(sync_leaf, params, anchor, err)
    new_params = tree_map(lambda o: o[0], out)
    new_err = tree_map(lambda o: o[1], out)
    return new_params, new_params, new_err


def crosspod_traffic_bytes(params, *, compressed: bool) -> int:
    """Per-sync traffic: int8 + fp32 block scales vs fp32."""
    total = 0
    for p in tree_leaves(params):
        n = p.numel()
        if compressed:
            total += n + (-(-n // 256)) * 4
        else:
            total += n * 4
    return total
