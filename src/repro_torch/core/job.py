"""Job: the workload granularity of Synergy (paper Listing 2 / Fig 3).

A *job* is the computation that produces one output tile ``C(t1, t2)`` of a
tiled matrix multiplication ``C[m, n] = A[m, k] @ B[k, n]``.  The paper's job
structure carries base addresses, GEMM dims, tile indices and the owning
layer id; addresses are meaningless to PyTorch, so the job here is pure
metadata used by the schedulers, cost models, and the roofline analysis.  The
actual tile compute is executed by the CUDA ``tiled_mm`` kernel, whose own
block tile is fixed: the job's tile sizes only shape this accounting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Sequence

__all__ = ["Job", "JobSet", "ceil_div", "chunk_by_macs"]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Job:
    """One tile job (paper Listing 2, minus raw pointers)."""

    layer_id: int
    t1: int  # output tile row index
    t2: int  # output tile col index
    m: int   # full GEMM rows
    n: int   # full GEMM cols
    k: int   # full GEMM contraction
    ts_m: int
    ts_n: int
    ts_k: int

    # ---- geometry -------------------------------------------------------
    @property
    def rows(self) -> int:
        """Valid rows in this tile (border tiles are zero-padded, §3.2.1)."""
        return min(self.ts_m, self.m - self.t1 * self.ts_m)

    @property
    def cols(self) -> int:
        return min(self.ts_n, self.n - self.t2 * self.ts_n)

    @property
    def is_border(self) -> bool:
        return self.rows < self.ts_m or self.cols < self.ts_n

    # ---- cost model inputs ----------------------------------------------
    @property
    def macs(self) -> int:
        """MACs actually executed: the fixed-size PE always computes the
        full padded tile (the paper's PEs do too — zero padding, not
        shortened loops)."""
        return self.ts_m * self.ts_n * self.k

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def bytes_moved(self) -> int:
        """HBM traffic for the job: stream a row-panel of A and a col-panel
        of B, write one C tile (fp32 = 4B; the paper uses fp32 throughout)."""
        return 4 * (self.ts_m * self.k + self.k * self.ts_n + self.ts_m * self.ts_n)


@dataclasses.dataclass(frozen=True)
class JobSet:
    """All jobs of one GEMM (one CONV layer after im2col, or one LM matmul)."""

    layer_id: int
    m: int
    n: int
    k: int
    ts_m: int
    ts_n: int
    ts_k: int
    name: str = ""

    @classmethod
    def for_gemm(cls, layer_id: int, m: int, n: int, k: int,
                 tile: int | tuple[int, int, int] = 32, name: str = "") -> "JobSet":
        if isinstance(tile, int):
            tile = (tile, tile, tile)
        ts_m, ts_n, ts_k = tile
        return cls(layer_id=layer_id, m=m, n=n, k=k,
                   ts_m=ts_m, ts_n=ts_n, ts_k=ts_k, name=name)

    @classmethod
    def for_conv(cls, layer_id: int, n_frames: int, h: int, w: int,
                 cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, tile: int | tuple[int, int, int] = 32,
                 name: str = "") -> "JobSet":
        """The im2col GEMM of one CONV layer over an ``n_frames`` image
        batch (§3.1.1): ``m = n_frames * oh * ow``, ``k = kernel² * cin``,
        ``n = cout`` — the REAL conv-as-GEMM shape the serving prefill
        path and the DES both account (one source of truth, so server
        busy-seconds and simulator busy-seconds agree by construction)."""
        oh = (h + 2 * padding - kernel) // stride + 1
        ow = (w + 2 * padding - kernel) // stride + 1
        return cls.for_gemm(layer_id, n_frames * oh * ow, cout,
                            kernel * kernel * cin, tile, name=name)

    @property
    def grid(self) -> tuple[int, int]:
        return (ceil_div(self.m, self.ts_m), ceil_div(self.n, self.ts_n))

    @property
    def num_jobs(self) -> int:
        g = self.grid
        return g[0] * g[1]

    @property
    def k_steps(self) -> int:
        return ceil_div(self.k, self.ts_k)

    def jobs(self) -> Iterator[Job]:
        gm, gn = self.grid
        for t1 in range(gm):
            for t2 in range(gn):
                yield Job(self.layer_id, t1, t2, self.m, self.n, self.k,
                          self.ts_m, self.ts_n, self.ts_k)

    # aggregate costs -------------------------------------------------------
    @property
    def total_macs(self) -> int:
        return self.num_jobs * self.ts_m * self.ts_n * self.k

    @property
    def useful_macs(self) -> int:
        return self.m * self.n * self.k

    @property
    def padding_waste(self) -> float:
        """Fraction of MACs spent on zero-padded borders (fixed-size PE tax)."""
        return 1.0 - self.useful_macs / max(1, self.total_macs)

    @property
    def total_flops(self) -> int:
        return 2 * self.total_macs


def total_jobs(jobsets: Sequence[JobSet]) -> int:
    return sum(js.num_jobs for js in jobsets)


def chunk_by_macs(jobsets: Sequence[JobSet],
                  budget_macs: Optional[int]) -> list[list[int]]:
    """Group consecutive jobsets into bounded-cost chunks: each chunk's
    summed ``total_macs`` stays under ``budget_macs`` where possible (a
    single jobset over budget still gets its own chunk — order is never
    broken, so layer dependencies survive the split).  ``None`` or a
    non-positive budget means ONE chunk.  Returns index groups, the unit
    of chunked prefill: the serving engine submits one group per step so
    a large admission wave cannot flood the queues ahead of decode."""
    n = len(jobsets)
    if not n:
        return []
    if not budget_macs or budget_macs <= 0:
        return [list(range(n))]
    chunks: list[list[int]] = []
    cur: list[int] = []
    cur_macs = 0
    for i, js in enumerate(jobsets):
        if cur and cur_macs + js.total_macs > budget_macs:
            chunks.append(cur)
            cur, cur_macs = [], 0
        cur.append(i)
        cur_macs += js.total_macs
    chunks.append(cur)
    return chunks


def arithmetic_intensity(js: JobSet) -> float:
    """FLOPs per HBM byte for one job — drives tile-size selection (§Perf)."""
    j = next(js.jobs())
    return j.flops / j.bytes_moved
