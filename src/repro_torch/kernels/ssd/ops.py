"""SSD wrapper: pre-scaling, op-variant dispatch via the
``repro_torch.engines`` registry, the chunked torch path (the same math as
the kernel, a loop over chunks: the counterpart of ``repro``'s
``ssd_chunked_xla``) and the checked wrapper of the CUDA kernel (K5).

Variants of the ``ssd`` op: ``cuda`` (:func:`ssd_cuda`), ``torch``
(:func:`ssd_chunked`) and ``ref`` (:func:`ssd_ref`), the counterparts of
``repro``'s ``pallas``, ``xla`` and ``ref``.  ``cuda`` is registered as
always available and routes on the operands' device: a CPU tensor takes
the plain version (:func:`ssd_chunked`), a CUDA tensor launches the kernel
or raises, a ``meta`` tensor is traced (nothing launched).
``ssd_cuda.launches`` counts calls of the kernel's entry point (one per
call: its two device kernels, C·Bᵀ and the scan, count once) and nothing
else, under the lock the other kernels' counts use.

Under autograd ``ssd_cuda`` runs through :class:`SSDFunction`: the forward
is the kernel (the same bits as inference), the backward the VJP of
:func:`ssd_chunked` recomputed from the saved inputs, as ``repro``
differentiates ``ssd_chunked_xla`` (it has no backward kernel)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.engines import register_op_impl, resolve_op
from repro_torch.kernels.common.gemm import (_DTYPE_CODES, _INT_MAX,
                                             count_launch, nbytes,
                                             report_meta_call)

from .ref import ssd_ref
from .ssd import (SSD_HEAD_DIMS, SSD_MAX_CHUNK, SSD_SHAPES,
                  SSD_STATE_SIZES, load_ssd)

__all__ = ["SSDFunction", "cb_workspace", "check_kernel_shape", "ssd",
           "ssd_chunked", "ssd_cuda", "ssd_flops"]


def _prescale(x, dt, a):
    """x (B,L,H,P), dt (B,L,H) [post-softplus], a (H,) [negative] ->
    kernel layout xdt (B,H,L,P), dta (B,H,L).

    xdt stays in x's dtype (an fp32 dt would otherwise promote the whole
    SSD pipeline to fp32); dta stays fp32 (tiny; drives the exps)."""
    xdt = (x * dt[..., None].to(x.dtype)).transpose(1, 2)
    dta = (dt * a[None, None, :]).transpose(1, 2)
    return xdt, dta


def ssd_chunked(xdt, dta, bm, cm, *, chunk: int = 128,
                seg_dtype: torch.dtype = torch.float32):
    """Chunked SSD in plain torch (a loop over chunks) — O(L Q), not
    O(L^2).  xdt (B,H,L,P), dta (B,H,L), bm/cm (B,L,N), L a multiple of
    ``chunk`` -> y (B,H,L,P) in xdt's dtype, final state (B,H,P,N) fp32.
    ``seg_dtype``: the dtype of the segment sums of dta (the exponents of
    the decays), which are rounded to fp32 before their exps."""
    b, h, l, p = xdt.shape
    n = bm.shape[-1]
    # fp32 accumulation (float64 operands, as gradcheck passes, keep theirs)
    f32 = torch.promote_types(xdt.dtype, torch.float32)
    sdt = torch.promote_types(f32, seg_dtype)
    cdt = xdt.dtype                         # compute dtype (bf16/f32)
    q = chunk
    tril = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    s = torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
    ys = []
    for c0 in range(0, l, q):
        xdt_i = xdt[:, :, c0:c0 + q]        # (B,H,Q,P)
        dta_i = dta[:, :, c0:c0 + q]        # (B,H,Q)
        bm_i = bm[:, c0:c0 + q]             # (B,Q,N)
        cm_i = cm[:, c0:c0 + q]
        seg = torch.cumsum(dta_i.to(sdt), dim=-1)
        total = seg[..., -1]
        # mask INSIDE the exp: the j > i half has positive exponents
        diff = torch.where(tril, seg[..., :, None] - seg[..., None, :],
                           -1e30)
        # the (Q, Q) decay and CB products run in the compute dtype, the
        # chunk products accumulate in fp32
        decay = torch.exp(diff.to(f32)).to(cdt)  # (B,H,Q,Q)
        cb = torch.einsum("bqn,bkn->bqk", cm_i.to(f32),
                          bm_i.to(f32)).to(cdt)
        y = torch.einsum("bhqk,bhkp->bhqp", (cb[:, None] * decay).to(f32),
                         xdt_i.to(f32))
        y = y + torch.exp(seg.to(f32))[..., None] * torch.einsum(
            "bqn,bhpn->bhqp", cm_i.to(f32), s)
        w = torch.exp((total[..., None] - seg).to(f32))
        w = w[..., None].to(cdt) * xdt_i
        s = (torch.exp(total.to(f32))[..., None, None] * s
             + torch.einsum("bhqp,bqn->bhpn", w.to(f32), bm_i.to(f32)))
        ys.append(y)
    y = (torch.cat(ys, dim=2) if ys
         else xdt.new_zeros((b, h, 0, p), dtype=f32))
    return y.to(xdt.dtype), s


def _check(xdt, dta, bm, cm, chunk: int) -> None:
    if xdt.dim() != 4 or dta.dim() != 3 or bm.dim() != 3 \
            or bm.shape != cm.shape:
        raise ValueError(f"ssd: need xdt (B,H,L,P), dta (B,H,L), bm/cm "
                         f"(B,L,N), got {tuple(xdt.shape)}, "
                         f"{tuple(dta.shape)}, {tuple(bm.shape)}, "
                         f"{tuple(cm.shape)}")
    b, h, l, _ = xdt.shape
    if tuple(dta.shape) != (b, h, l) or tuple(bm.shape[:2]) != (b, l):
        raise ValueError(f"ssd: dta {tuple(dta.shape)} / bm "
                         f"{tuple(bm.shape)} do not match xdt "
                         f"{tuple(xdt.shape)}")
    if chunk < 1 or l % chunk:
        raise ValueError(f"ssd: L = {l} is not a multiple of chunk {chunk}")
    if xdt.dtype not in _DTYPE_CODES or bm.dtype != xdt.dtype \
            or cm.dtype != xdt.dtype or dta.dtype != torch.float32:
        raise TypeError(f"ssd: xdt, bm and cm must share a dtype in "
                        f"{list(_DTYPE_CODES)} and dta be float32, got "
                        f"{xdt.dtype}, {bm.dtype}, {cm.dtype}, {dta.dtype}")
    devices = {t.device for t in (xdt, dta, bm, cm)}
    if len(devices) != 1:
        raise ValueError(f"ssd: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (xdt, dta, bm, cm)):
        raise ValueError("ssd: xdt, dta, bm and cm must be contiguous")


def check_kernel_shape(b: int, h: int, l: int, p: int, n: int,
                       chunk: int) -> None:
    """Raise unless the kernel is built for this shape: (P, N) in
    :data:`~.ssd.SSD_SHAPES`, a chunk of at most SSD_MAX_CHUNK, B and H
    within the grid."""
    if (p, n) not in SSD_SHAPES or chunk > SSD_MAX_CHUNK:
        raise ValueError(f"ssd: the kernel takes P in {SSD_HEAD_DIMS}, N in "
                         f"{SSD_STATE_SIZES} and chunks up to "
                         f"{SSD_MAX_CHUNK}, got P={p} N={n} chunk={chunk}")
    if b > 65535 or h > _INT_MAX or l > _INT_MAX:
        raise ValueError("ssd: a dimension exceeds the grid")


def cb_workspace(b: int, l: int, chunk: int,
                 device: torch.device) -> torch.Tensor:
    """The kernel's scratch for the causal half of C·Bᵀ: one (Q x Q) fp32
    tile per batch row and chunk, B·(L/Q)·Q² elements, uninitialised (the
    kernel writes every element it reads)."""
    return torch.empty(b * (l // chunk) * chunk * chunk,
                       dtype=torch.float32, device=device)


def ssd_flops(b: int, h: int, l: int, p: int, n: int, chunk: int) -> float:
    """The dot flops of :func:`ssd_chunked` (and of ``repro``'s
    ``ssd_chunked_xla``) per call: each of the L/Q chunks makes C·Bᵀ
    (2·B·Q²·N), its decayed product with xdt (2·B·H·Q²·P), C against the
    carried state (2·B·H·Q·P·N) and the state update (2·B·H·P·N·Q)."""
    q = chunk
    per_chunk = 2 * b * q * q * n + 2 * b * h * q * q * p \
        + 4 * b * h * q * p * n
    return float(per_chunk * (l // q))


def _ssd_forward(xdt: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor,
    a traced call for a ``meta`` tensor (the outputs' and the workspace's
    stand-ins; the call reported with :func:`ssd_flops`)."""
    if xdt.device.type == "cpu":
        return ssd_chunked(xdt, dta, bm, cm, chunk=chunk)
    if xdt.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd: no kernel for device {xdt.device}")
    b, h, l, p = xdt.shape
    n = bm.shape[-1]
    check_kernel_shape(b, h, l, p, n, chunk)
    y = torch.empty_like(xdt)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    if xdt.numel() == 0:
        return y, state
    cbw = cb_workspace(b, l, chunk, xdt.device)
    if xdt.device.type == "meta":
        report_meta_call("ssd", ssd_flops(b, h, l, p, n, chunk),
                         nbytes(xdt, dta, bm, cm, y, state))
        return y, state
    entry = load_ssd().ssd
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        rc = entry(xdt.data_ptr(), dta.data_ptr(), bm.data_ptr(),
                   cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                   cbw.data_ptr(), b, h, l, p, n, chunk,
                   _DTYPE_CODES[xdt.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd: kernel launch failed with CUDA error {rc} "
                           f"for xdt {tuple(xdt.shape)}, N={n}, "
                           f"chunk={chunk}")
    count_launch(ssd_cuda)
    return y, state


class SSDFunction(torch.autograd.Function):
    """K5 under autograd.  Forward: :func:`_ssd_forward` (the kernel on the
    card, the plain version on the CPU), saving only the inputs.  Backward:
    the VJP of :func:`ssd_chunked` recomputed from them, a gradient for
    each of xdt, dta, bm and cm; the final state is differentiable too
    (its gradient, when one reaches it, joins y's in the same VJP).  The
    segment sums of dta are recomputed in float64 (``seg_dtype``), so
    that dta's gradient sums back through their differences in float64:
    in fp32 their cancellation makes the gradient of ``a_log`` wrong by
    ~1e-5 of its largest entry (reduced mamba2-130m, 16 tokens) and
    depend on how the products over P are grouped (P split over 'model'
    regroups them).  Everything that autograd saves stays in the
    inputs' dtypes and fp32, as in the forward."""

    @staticmethod
    def forward(ctx, xdt, dta, bm, cm, chunk):
        ctx.save_for_backward(xdt, dta, bm, cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd_forward(xdt, dta, bm, cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ssd_chunked(*inputs, chunk=ctx.chunk,
                               seg_dtype=torch.float64)
            pairs = [(o, g) for o, g in zip(outs, (gy, gstate))
                     if g is not None]
            grads = list(torch.autograd.grad(
                [o for o, _ in pairs], [t for t in inputs if t.requires_grad],
                [g for _, g in pairs], allow_unused=True))
        return (*(grads.pop(0) if n else None for n in need), None)


def ssd_cuda(xdt: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, *, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan by the CUDA kernel: xdt (B,H,L,P), dta (B,H,L)
    fp32, bm/cm (B,L,N) in xdt's dtype, L a multiple of ``chunk`` ->
    y (B,H,L,P) in xdt's dtype and the final state (B,H,P,N) fp32.  When
    autograd records the call it runs through :class:`SSDFunction`."""
    _check(xdt, dta, bm, cm, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dta, bm, cm)):
        return SSDFunction.apply(xdt, dta, bm, cm, chunk)
    return _ssd_forward(xdt, dta, bm, cm, chunk)


ssd_cuda.launches = 0


register_op_impl(
    "ssd", "cuda",
    lambda xdt, dta, bm, cm, *, chunk: ssd_cuda(xdt, dta, bm, cm,
                                                chunk=chunk),
    priority=10)
register_op_impl(
    "ssd", "torch",
    lambda xdt, dta, bm, cm, *, chunk: ssd_chunked(xdt, dta, bm, cm,
                                                   chunk=chunk),
    priority=0)
register_op_impl(
    "ssd", "ref",
    lambda xdt, dta, bm, cm, *, chunk: ssd_ref(xdt, dta, bm, cm),
    priority=-10)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128,
        impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD.  x (B,L,H,P), dt (B,L,H) post-softplus, a (H,) negative,
    bm/cm (B,L,N).  Returns y (B,L,H,P) and final state (B,H,P,N).

    L is padded up to a chunk multiple with zeros — zero xdt/dta steps are
    identity for the recurrence (state unchanged), so padding is exact."""
    l_orig = x.shape[1]
    chunk = min(chunk, max(1, l_orig))
    pad = (-l_orig) % chunk
    if pad:
        padl = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        x, dt, bm, cm = padl(x), padl(dt), padl(bm), padl(cm)
    xdt, dta = _prescale(x, dt, a)
    y, s = resolve_op("ssd", impl)(xdt.contiguous(), dta.contiguous(),
                                   bm.contiguous(), cm.contiguous(),
                                   chunk=chunk)
    y = y.transpose(1, 2)
    return (y[:, :l_orig] if pad else y), s
