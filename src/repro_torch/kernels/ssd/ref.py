"""Plain PyTorch oracle for the SSD scan: the direct O(L) recurrence, the
counterpart of ``repro``'s ``ssd_ref``.

    S_t = exp(dt_t * A_h) * S_{t-1} + xdt_t (x) B_t
    y_t = S_t @ C_t
"""

from __future__ import annotations

import torch

__all__ = ["ssd_ref"]


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
