#!/usr/bin/env python3
"""K5 (``ssd``) beside its frozen witness, on one card.

    python3 scripts/ssd_probe.py [--variants slab16,no_exp,...] [--ablate]
                                 [--reps 25]

Builds ``csrc/ssd.cu``, the witness ``csrc/ssd_witness.cu`` (the kernel's
first version) and a copy of ``ssd.cu`` for each named variant (EDITS: the
source with a few lines replaced), all at once, and prints what ``nvcc
-Xptxas -v`` says of each (registers, spills).  Then holds y and the
final state of the kernel and of every variant bitwise (``torch.equal``)
to the witness at every ``chip_smoke.py`` SSD_CASES and BWD_SSD_CASES
shape and at edge chunks (100, 48, 5, 1), in fp32 and bf16, and times
each beside the witness at the LM prefill's and the training step's
shapes (CUDA-event medians, in turns: witness, the kernel and the
variants, the same reversed, witness).

``slab16`` runs slabs of 16 of P's 64 columns in place of 32.  The
``no_*`` variants (``--ablate`` takes them all) compile one part out:
the decay's exps, G·xdt, C·Sᵀ, the state update, the per-chunk staging.
Their results are wrong on purpose: they are timed, to show what each
part costs, and skip the bitwise check.

One JSON line per check and per timing; the card and its power limit
first.  Exits non-zero on a mismatch or without a card.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (BWD_SSD_CASES, DEVICE, SSD_CASES, card_line,  # noqa: E402
                        emit, first_mismatch, median_ms, ssd_bound,
                        ssd_inputs, ssd_operands, witness_shapes)
from repro_torch.kernels.common import build  # noqa: E402
from repro_torch.kernels.common.gemm import _DTYPE_CODES  # noqa: E402
from repro_torch.kernels.ssd.ops import cb_workspace  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_witness  # noqa: E402
from repro_torch.kernels.ssd.ssd import (SSD_ARGTYPES, _SOURCE,  # noqa: E402
                                         load_ssd, load_ssd_witness)

#: chunks the main paths do not use, but ``ssd`` may hand the kernel:
#: (label, B, L, H, P, N, chunk)
EDGE_SHAPES = [("chunk 100", 1, 200, 3, 64, 64, 100),
               ("chunk 48, N 128", 1, 96, 2, 64, 128, 48),
               ("chunk 5", 2, 15, 2, 16, 16, 5),
               ("chunk 1", 1, 3, 2, 64, 64, 1)]
#: variant -> [(text of ssd.cu, its replacement), ...], each found once;
#: the ``no_*`` ones compile a part out (timed only)
EDITS = {
    "slab16": [("constexpr int PS = P == 64 ? 32 : P;",
                "constexpr int PS = P == 64 ? 16 : P;")],
    "no_exp": [("round_as<T>(Gw[e] * expf(seg[i] - seg[j]))", "Gw[e]")],
    "no_gx": [("for (; j + 4 <= jend; j += 4) {",
               "for (j = jend; j + 4 <= jend; j += 4) {")],
    "no_cs": [("for (int n = 0; n < N; n += 4) {",
               "for (int n = N; n < N; n += 4) {")],
    "no_state": [("    for (int j = 0; j < q; ++j) {",
                  "    for (int j = q; j < q; ++j) {")],
    "no_restage": [
        ("    stage(CBs, N, bp + (int64_t)c0 * N, N, q, N, tid, THREADS);",
         ""),
        ("if (c + 1 < nc) stage_cb(c + 1);", ""),
        ("if (c + 1 < nc) stage_xc(c + 1);", "")],
}


def variant(name: str) -> ctypes.CDLL:
    """``ssd.cu`` with ``EDITS[name]`` made, built and bound like the
    kernel."""
    text = _SOURCE.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"ssd_probe: {old!r} is not in ssd.cu once")
        text = text.replace(old, new)
    src = build._BUILD_DIR / "variants" / f"ssd_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    lib = ctypes.CDLL(str(build.build_library(f"ssd_{name}", src)))
    lib.ssd.argtypes = SSD_ARGTYPES
    lib.ssd.restype = ctypes.c_int
    return lib


def run(lib: ctypes.CDLL, xdt, dta, bm, cm, chunk: int) -> tuple:
    b, h, l, p = xdt.shape
    n = bm.shape[-1]
    y = torch.empty_like(xdt)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    cbw = cb_workspace(b, l, chunk, xdt.device)
    rc = lib.ssd(xdt.data_ptr(), dta.data_ptr(), bm.data_ptr(),
                 cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 cbw.data_ptr(), b, h, l, p, n, chunk,
                 _DTYPE_CODES[xdt.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd: CUDA error {rc}")
    return y, state


def ptxas_report(name: str) -> list[str]:
    """The ``-Xptxas -v`` lines of the newest build of ``name``."""
    logs = sorted(build._BUILD_DIR.glob(f"{name}-*.log"),
                  key=lambda p: p.stat().st_mtime)
    if not logs:
        return ["(no build log: the library was already built)"]
    return [line.strip() for line in logs[-1].read_text().splitlines()
            if re.search(r"registers|spill|Compiling entry", line)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    names = [n for n in args.variants.split(",") if n]
    if args.ablate:
        names += [n for n in EDITS if n.startswith("no_") and n not in names]
    unknown = set(names) - set(EDITS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: {list(EDITS)}")
    kernels = ["ssd", *names]
    checked = [n for n in kernels if not n.startswith("no_")]
    libs, errors = {}, []

    def build_one(key, fn):
        try:
            libs[key] = fn()
        except BaseException as e:       # re-raised below, on this thread
            errors.append(e)

    jobs = [("witness", load_ssd_witness), ("ssd", load_ssd)] + [
        (name, lambda n=name: variant(n)) for name in names]
    threads = [threading.Thread(target=build_one, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for s in kernels:
        name = s if s == "ssd" else f"ssd_{s}"
        emit({"ptxas": name, "report": ptxas_report(name)})
    emit({"ptxas": "ssd_witness", "report": ptxas_report("ssd_witness")})

    g = torch.Generator(device=DEVICE).manual_seed(16)
    bad = 0
    for label, b, l, h, p, n, chunk in witness_shapes() + EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xdt, dta, bm, cm, q = ssd_operands(
                *ssd_inputs(g, b, l, h, p, n, dtype), chunk)
            wy, wst = ssd_witness(xdt, dta, bm, cm, chunk=q)
            for s in checked:
                y, st = run(libs[s], xdt, dta, bm, cm, q)
                torch.cuda.synchronize()
                ok_y, ok_s = torch.equal(y, wy), torch.equal(st, wst)
                bad += not (ok_y and ok_s)
                emit({"witness_check": label, "variant": s,
                      "shape": [b, l, h, p, n], "chunk": q,
                      "dtype": str(dtype), "y_equal": ok_y,
                      "state_equal": ok_s,
                      **({} if ok_y else {"y": first_mismatch(y, wy)}),
                      **({} if ok_s else {"state": first_mismatch(st, wst)})})

    for key, case in (("lm_prefill", SSD_CASES[0]),
                      ("lm_prefill bf16", SSD_CASES[1]),
                      ("mamba2-130m", SSD_CASES[2]),
                      ("training", BWD_SSD_CASES[0])):
        _, b, l, h, p, n, chunk, dtype = case
        xdt, dta, bm, cm, q = ssd_operands(
            *ssd_inputs(g, b, l, h, p, n, dtype), chunk)
        order = ["witness", *kernels, *reversed(kernels), "witness"]
        times = {k: [] for k in order}
        for k in order:
            fn = ((lambda: ssd_witness(xdt, dta, bm, cm, chunk=q))
                  if k == "witness"
                  else (lambda k=k: run(libs[k], xdt, dta, bm, cm, q)))
            times[k].append(median_ms(fn, reps=args.reps))
        bound_ms, bound_by = ssd_bound(b, l, h, p, n, xdt.element_size())
        emit({"timing": key, "shape": [b, l, h, p, n], "chunk": q,
              "dtype": str(dtype), "ms": {str(k): v for k, v in times.items()},
              "bound_ms": bound_ms, "bound_by": bound_by,
              "per": "one call, CUDA-event median of --reps", "card": card})
    print(f"card: {card}", flush=True)
    print(f"ssd_probe: {bad} mismatches", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
