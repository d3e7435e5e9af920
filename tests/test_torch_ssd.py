"""The SSD scan (K5) in the port against repro, on the CPU: the kernel's
wrapper (its plain version, the chunked torch path, on CPU tensors), the
'torch' and 'ref' variants and the pre-scaling, each on the same numpy
inputs as repro's Pallas kernel (interpret mode), its chunked XLA path and
its recurrence oracle.  Tolerance 2e-5 (tests/test_ssd.py).  Chunks 16-64,
L padded to a chunk multiple, the zoo's state sizes, gradients."""

import ctypes
import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as j_ssd
from repro.kernels.ssd import ssd_ref as j_ssd_ref
from repro.kernels.ssd.ops import _prescale as j_prescale
from repro.kernels.ssd.ops import ssd_chunked_xla
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_cuda, ssd_ref
from repro_torch.kernels.ssd.ops import (_prescale, cb_workspace,
                                         check_kernel_shape)
from repro_torch.kernels.ssd.ref import ssd_witness
from repro_torch.kernels.ssd.ssd import (SSD_ARGTYPES, SSD_MAX_CHUNK,
                                         SSD_SHAPES, SSD_WITNESS_ARGTYPES)

TOL = 2e-5


def _inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)) - 1.0,
                      0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_cuda_variant_matches_pallas(chunk):
    inp = _inputs(2, 128, 3, 16, 8)
    before = ssd_cuda.launches
    y, s = ssd(*_t(*inp), chunk=chunk, impl="cuda")
    assert ssd_cuda.launches == before       # CPU: the plain version
    jy, js = j_ssd(*inp, chunk=chunk, impl="pallas")
    _close(y, jy)
    _close(s, js)
    xdt, dta = j_prescale(*inp[:3])
    ry, rs = j_ssd_ref(xdt, dta, *map(jnp.asarray, inp[3:]))
    _close(y, np.swapaxes(np.asarray(ry), 1, 2))
    _close(s, rs)


@pytest.mark.parametrize("impl,j_impl", [("cuda", "pallas"),
                                         ("torch", "xla"), ("ref", "ref")])
def test_variants_match_repro(impl, j_impl):
    inp = _inputs(1, 64, 2, 8, 4, seed=3)
    y, s = ssd(*_t(*inp), chunk=16, impl=impl)
    jy, js = j_ssd(*inp, chunk=16, impl=j_impl)
    _close(y, jy)
    _close(s, js)


def test_prescale_matches_repro():
    x, dt, a, _, _ = _inputs(2, 24, 3, 8, 4, seed=4)
    xdt, dta = _prescale(*_t(x, dt, a))
    j_xdt, j_dta = j_prescale(x, dt, a)
    _close(xdt, j_xdt, tol=0)
    _close(dta, j_dta, tol=0)


def test_chunked_matches_xla_and_ref():
    x, dt, a, bm, cm = _inputs(1, 96, 2, 8, 4, seed=1)
    xdt, dta = j_prescale(x, dt, a)
    args = _t(np.asarray(xdt), np.asarray(dta), bm, cm)
    y, s = ssd_chunked(*args, chunk=32)
    jy, js = ssd_chunked_xla(xdt, dta, bm, cm, chunk=32)
    _close(y, jy)
    _close(s, js)
    ry, rs = ssd_ref(*args)
    jry, jrs = j_ssd_ref(xdt, dta, jnp.asarray(bm), jnp.asarray(cm))
    _close(ry, jry)
    _close(rs, jrs)


@pytest.mark.parametrize("l,chunk", [(100, 32), (1000, 128), (5, 128)])
def test_padding_to_a_chunk_multiple(l, chunk):
    """L padded with zeros inside ``ssd`` (exact: a zero step is the
    identity); L < chunk shrinks the chunk to L, as repro does."""
    inp = _inputs(2, l, 2, 16, 8, seed=l)
    y, s = ssd(*_t(*inp), chunk=chunk, impl="cuda")
    assert y.shape == (2, l, 2, 16)
    jy, js = j_ssd(*inp, chunk=chunk, impl="pallas")
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("n", [64, 128])
def test_zoo_state_sizes(n):
    """P = 64 with zamba2's N = 64 and mamba2-130m's N = 128."""
    inp = _inputs(1, 64, 2, 64, n, seed=n)
    y, s = ssd(*_t(*inp), chunk=32, impl="cuda")
    jy, js = j_ssd(*inp, chunk=32, impl="xla")
    _close(y, jy)
    _close(s, js)


def test_reduced_shape_matches_pallas():
    """P = 16, N = 16, chunk 16: what ``reduced()`` gives every SSM arch."""
    inp = _inputs(2, 48, 3, 16, 16, seed=16)
    y, s = ssd(*_t(*inp), chunk=16, impl="cuda")
    jy, js = j_ssd(*inp, chunk=16, impl="pallas")
    _close(y, jy)
    _close(s, js)


def _zoo_ssd_shapes():
    """(P, N, chunk) of the SSM and hybrid archs, published and reduced."""
    cfgs = [c for c in ARCHS.values() if c.family in ("ssm", "hybrid")]
    return sorted({(c.ssm_head_dim, c.ssm_state, c.ssm_chunk)
                   for c in cfgs + [reduced(c) for c in cfgs]})


@pytest.mark.parametrize("p,n,chunk", _zoo_ssd_shapes())
def test_kernel_is_built_for_every_zoo_ssd_shape(p, n, chunk):
    assert (p, n) in SSD_SHAPES and chunk <= SSD_MAX_CHUNK
    check_kernel_shape(2, 8, 4 * chunk, p, n, chunk)


@pytest.mark.parametrize("p", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [16, 64, 128])
def test_kernel_takes_a_ranks_share_of_p(p, n):
    """P 64 (16 reduced) split over 2, 4 or 16 'model' ranks: the kernel is
    built for every such P at every state size of the zoo."""
    assert (p, n) in SSD_SHAPES
    check_kernel_shape(4, 80, 1024, p, n, 128)


def test_meta_route_at_p4_reports_its_call():
    """A rank of the production mesh hands K5 P = 64 / 16 = 4 columns: the
    ``meta`` route (the dry run) takes the call and reports it with its
    plain formulation's flops."""
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.kernels.ssd.ops import ssd_flops
    b, h, l, p, n, chunk = 4, 80, 1024, 4, 64, 128
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    (y, st), acct = analyze_step(ssd_cuda, meta(b, h, l, p), meta(b, h, l),
                                 meta(b, l, n), meta(b, l, n), chunk=chunk)
    assert y.shape == (b, h, l, p) and st.shape == (b, h, p, n)
    assert acct.kernels == {"ssd": 1}
    assert acct.kernel_flops["ssd"] == ssd_flops(b, h, l, p, n, chunk)


@pytest.mark.parametrize("p,n,chunk", [(12, 64, 16), (64, 32, 16),
                                       (32, 32, 32), (16, 16, 256),
                                       (128, 128, 64)])
def test_kernel_shape_check_refuses_other_shapes(p, n, chunk):
    with pytest.raises(ValueError, match="the kernel takes"):
        check_kernel_shape(2, 8, 4 * chunk, p, n, chunk)


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_chunk_invariance(nc):
    inp = _t(*_inputs(2, 32 * nc, 3, 8, 4, seed=nc))
    y1, s1 = ssd(*inp, chunk=32, impl="torch")
    y2, s2 = ssd(*inp, chunk=16, impl="torch")
    torch.testing.assert_close(y1, y2, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(s1, s2, rtol=3e-5, atol=3e-5)


def test_gradients_finite():
    x, dt, a, bm, cm = _t(*_inputs(1, 64, 2, 8, 4, seed=2))
    x.requires_grad_(True)
    y, _ = ssd(x, dt, a, bm, cm, chunk=16, impl="torch")
    torch.sum(y ** 2).backward()
    assert torch.isfinite(x.grad).all()


def test_wrapper_checks():
    x, dt, a, bm, cm = _t(*_inputs(1, 32, 2, 8, 4))
    xdt, dta = _prescale(x, dt, a)
    xdt, dta = xdt.contiguous(), dta.contiguous()
    with pytest.raises(ValueError, match="multiple"):
        ssd_cuda(xdt, dta, bm, cm, chunk=24)
    with pytest.raises(TypeError):
        ssd_cuda(xdt, dta, bm.double(), cm, chunk=16)
    with pytest.raises(TypeError):
        ssd_cuda(xdt, dta.double(), bm, cm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(xdt.transpose(2, 3).contiguous().transpose(2, 3), dta, bm,
                 cm, chunk=16)
    with pytest.raises(ValueError):
        ssd_cuda(xdt, dta[:, :1], bm, cm, chunk=16)


# ------------------------------------------- the kernel's frozen witness

#: SHA-256 of csrc/ssd_witness.cu: the kernel's first version with only its
#: entry point's and device function's names changed and epilogue.cuh's
#: helpers inlined.  The card tests hold the kernel to it bit for bit, so
#: it must not drift.
WITNESS_SHA256 = ("21fbb1f4501219fd17ee39acccecc20a"
                  "22519226bb7aaaebf500ebb319507e62")


def test_witness_source_is_pinned():
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "ssd" / "csrc" / "ssd_witness.cu")
    assert hashlib.sha256(src.read_bytes()).hexdigest() == WITNESS_SHA256


@pytest.mark.parametrize("b,l,chunk", [(4, 1024, 128), (2, 1024, 128),
                                       (2, 96, 16), (1, 15, 5)])
def test_workspace_is_one_cb_tile_per_batch_row_and_chunk(b, l, chunk):
    """The wrapper's C·Bᵀ scratch: B·(L/Q)·Q² fp32 elements, passed as the
    entry point's seventh pointer (the witness's entry point has none)."""
    want = b * (l // chunk) * chunk * chunk
    ws = cb_workspace(b, l, chunk, torch.device("cpu"))
    assert ws.dtype == torch.float32 and ws.numel() == want
    assert len(SSD_ARGTYPES) == 15 and len(SSD_WITNESS_ARGTYPES) == 14
    assert SSD_ARGTYPES[:7] == [ctypes.c_void_p] * 7
    assert SSD_ARGTYPES[7:14] == [ctypes.c_int] * 7


def test_importing_the_kernel_modules_builds_nothing():
    """Importing ssd.py, ref.py and the package builds and loads no
    library: the witness, like the kernel, is built at first use."""
    code = textwrap.dedent("""
        from repro_torch.kernels.common import build
        calls = []
        build.build_library = lambda *a, **k: calls.append(a)
        import repro_torch.kernels.ssd.ssd, repro_torch.kernels.ssd.ref
        import repro_torch.kernels.ssd
        assert not calls and not build._libs, (calls, build._libs)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve()
                                           .parents[1] / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_witness_takes_cuda_tensors_only():
    x, dt, a, bm, cm = _t(*_inputs(1, 32, 2, 16, 16))
    xdt, dta = (t.contiguous() for t in _prescale(x, dt, a))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_witness(xdt, dta, bm, cm, chunk=16)
