"""Checked wrapper of the CUDA ``flash_attention`` kernel (K4) and the
``flash_attention`` op, dispatched through the op-variant registry
(:mod:`repro_torch.engines`): variant ``cuda`` (the kernel's wrapper) and
``torch`` (the plain version), the counterparts of ``repro``'s ``pallas``
and ``xla``.

A CPU tensor takes the plain version (:func:`attention_ref`); a CUDA tensor
launches the kernel or raises; a ``meta`` tensor is traced (nothing
launched).  ``cuda`` is registered as always available and routes on the
operands' device, so ``"auto"`` resolves to it on every machine.
``flash_attention_cuda.launches`` counts kernel launches and nothing
else, under the lock the other kernels' counts use.

Under autograd ``flash_attention_cuda`` runs through
:class:`FlashAttentionFunction`: the forward is the kernel (the same bits
as inference), the backward the VJP of :func:`attention_ref` recomputed
from the saved inputs, as ``repro`` differentiates its ``xla`` variant (it
has no backward kernel)."""

from __future__ import annotations

import math

import torch

from repro_torch.engines import register_op_impl, resolve_op
from repro_torch.kernels.common.gemm import (_DTYPE_CODES, _INT_MAX,
                                             count_launch, misaligned, nbytes,
                                             report_meta_call)

from .flash_attention import HEAD_DIMS, load_flash_attention
from .ref import attention_ref

__all__ = ["FlashAttentionFunction", "check_kernel_shape",
           "flash_attention", "flash_attention_cuda"]


def _check(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: need q (B, Hq, S, D) and k/v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 \
            or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Hq % Hkv must be 0)")
    if causal and s != k.shape[2]:
        # the kernel aligns the mask top-left (row >= col), as repro's
        # Pallas kernel does; the plain version bottom-right, as
        # attention_ref does.  They agree only when S == Sk.
        raise ValueError(f"flash_attention: causal needs S == Sk, got "
                         f"{s} and {k.shape[2]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype in "
                        f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def check_kernel_shape(b: int, hq: int, s: int, sk: int, d: int) -> None:
    """Raise unless the kernel is built for this shape: head dim in
    :data:`~.flash_attention.HEAD_DIMS`, B and Hq within the grid."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if max(b, hq) > 65535 or max(s, sk) > _INT_MAX:
        raise ValueError(f"flash_attention: B {b} or Hq {hq} exceeds the "
                         f"grid's 65535, or S/Sk exceeds 2**31 - 1")


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, scale: float) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor,
    a traced call for a ``meta`` tensor (the output's stand-in; the call
    reported with :func:`attention_ref`'s dot flops)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    check_kernel_shape(b, hq, s, sk, d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    # the kernels stage rows by 16-byte copies: a contiguous view that
    # starts elsewhere is copied (same values)
    q, k, v = (t.clone() if misaligned(t) else t for t in (q, k, v))
    if q.device.type == "meta":
        # Q·Kᵀ and P·V, each 2·B·Hq·S·Sk·D, over the whole (masked) square
        report_meta_call("flash_attention", 4.0 * b * hq * s * sk * d,
                         nbytes(q, k, v, out))
        return out
    entry = load_flash_attention().flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, hq, hkv, s, sk, d, float(scale), int(causal),
                   _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}")
    count_launch(flash_attention_cuda)
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """K4 under autograd.  Forward: :func:`_flash_forward` (the kernel on
    the card, the plain version on the CPU), saving only q, k and v.
    Backward: the VJP of :func:`attention_ref` recomputed from them, a
    gradient for each of q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash_forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, go):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*inputs, causal=ctx.causal, scale=ctx.scale)
            grads = list(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], go))
        return (*(grads.pop(0) if n else None for n in need), None, None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """softmax(Q Kᵀ · scale) V per (batch, q-head), fp32 accumulation,
    output in q's dtype; q-head h reads kv head ``h // (Hq // Hkv)``, so
    K/V are never repeated.  Any S and Sk: the ragged edges are masked in
    the kernel.  When autograd records the call it runs through
    :class:`FlashAttentionFunction`."""
    _check(q, k, v, causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale)


flash_attention_cuda.launches = 0


register_op_impl(
    "flash_attention", "torch",
    lambda q, k, v, *, causal, scale: attention_ref(
        q, k, v, causal=causal, scale=scale),
    priority=0)
register_op_impl(
    "flash_attention", "cuda",
    lambda q, k, v, *, causal, scale: flash_attention_cuda(
        q, k, v, causal=causal, scale=scale),
    priority=10)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """q (B, Hq, S, D); k/v (B, Hkv, Sk, D) -> (B, Hq, S, D).

    impl: a registered ``flash_attention`` variant name, or 'auto'.  The
    CUDA kernel keeps its own tiling (64 query rows, 64 or 32 keys), so
    ``repro``'s Pallas block sizes have no counterpart here."""
    fn = resolve_op("flash_attention", impl)
    return fn(q, k, v, causal=causal, scale=scale)
