"""Plain PyTorch oracle for the SSD scan: the direct O(L) recurrence, the
counterpart of ``repro``'s ``ssd_ref``,

    S_t = exp(dt_t * A_h) * S_{t-1} + xdt_t (x) B_t
    y_t = S_t @ C_t

and :func:`ssd_witness`, the frozen first version of the CUDA kernel
(``csrc/ssd_witness.cu``) that the card tests hold the kernel to bit for
bit.  Nothing on a main path calls the witness.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common.gemm import _DTYPE_CODES

from .ssd import load_ssd_witness

__all__ = ["ssd_ref", "ssd_witness"]


def ssd_ref(xdt: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor,
            cm: torch.Tensor, state0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt (B,H,L,P), dta (B,H,L), bm/cm (B,L,N) -> y (B,H,L,P),
    S (B,H,P,N) fp32."""
    b, h, l, p = xdt.shape
    n = bm.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
         if state0 is None else state0.to(f32))
    ys = []
    for t in range(l):
        a_t = torch.exp(dta[:, :, t].to(f32))[..., None, None]     # (B,H,1,1)
        outer = (xdt[:, :, t, :, None].to(f32)
                 * bm[:, None, t, None, :].to(f32))                # (B,H,P,N)
        s = a_t * s + outer
        ys.append(torch.einsum("bhpn,bn->bhp", s, cm[:, t].to(f32)))
    y = (torch.stack(ys, dim=2) if ys
         else xdt.new_zeros((b, h, 0, p), dtype=f32))
    return y.to(xdt.dtype), s


def ssd_witness(xdt: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor,
                cm: torch.Tensor, *, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's first version on the kernel's layout: xdt (B,H,L,P),
    dta (B,H,L) fp32, bm/cm (B,L,N) in xdt's dtype, all contiguous CUDA
    tensors, L a multiple of ``chunk`` -> y (B,H,L,P), final state
    (B,H,P,N) fp32.  Raises on anything else: it has no plain version."""
    tensors = (xdt, dta, bm, cm)
    if not all(t.device.type == "cuda" for t in tensors):
        raise ValueError("ssd_witness: takes CUDA tensors only")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_witness: operands must be contiguous")
    b, h, l, p = xdt.shape
    n = bm.shape[-1]
    if xdt.dtype not in _DTYPE_CODES or {bm.dtype, cm.dtype} != {xdt.dtype} \
            or dta.dtype != torch.float32 or chunk < 1 or l % chunk:
        raise ValueError(f"ssd_witness: bad operands {xdt.dtype} "
                         f"{tuple(xdt.shape)}, chunk {chunk}")
    y = torch.empty_like(xdt)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    entry = load_ssd_witness().ssd_witness
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        rc = entry(xdt.data_ptr(), dta.data_ptr(), bm.data_ptr(),
                   cm.data_ptr(), y.data_ptr(), state.data_ptr(), b, h, l,
                   p, n, chunk, _DTYPE_CODES[xdt.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_witness: launch failed with CUDA error {rc}")
    return y, state
