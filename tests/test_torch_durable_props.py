"""``tests/test_durable_props.py``'s property on ``repro``'s server and the
port's: for crash points, admission modes (blocking wave or chunked
prefill), snapshot cadences and a torn-or-clean journal tail, over a
2-tenant server,

* every token stream after ``restore`` is bitwise the uninterrupted
  run's;
* every accepted request is served exactly once — restored
  ``tokens_out`` + ``replayed_tokens`` equals the uninterrupted run's
  ``tokens_out``, and no request finishes short or long;
* FairShare virtual times converge to the uninterrupted run's;
* both packages' counters are equal case by case.

The cases are drawn once from a seeded numpy generator (a fixed list, so
every run checks the same ones and no property-test database is written).
"""

import struct

import numpy as np
import pytest

from repro.soc import SimulatedCrash as JaxSimulatedCrash
from repro_torch.soc import SimulatedCrash
from test_torch_durable import (_acme_bulk, _reqs, _tenants,
                                assert_durable_stats, durable_pair,
                                reference, restore_both)
from test_torch_serving import submit_all

_HDR = struct.Struct("<II")
CHUNK_MACS = 2_000


def _cases(n=10, seed=10):
    """(crash_at, chunked, snapshot_every, torn_tail) as the reference's
    strategies draw them: crash_at in [1, 16], snapshot_every in {0, 2, 4}."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 17)), bool(rng.integers(2)),
             int(rng.choice([0, 2, 4])), bool(rng.integers(2)))
            for _ in range(n)]


CASES = _cases()
_REF = {}


def _kw(chunked):
    return {"prefill_chunk_macs": CHUNK_MACS} if chunked else {}


def _reference(chunked):
    """The uninterrupted run for one admission mode (computed once)."""
    if chunked not in _REF:
        jkw, tkw = _tenants()
        ref, js, ts = reference(5, tenant=_acme_bulk, jax_kw=jkw,
                                torch_kw=tkw, **_kw(chunked))
        assert ts._fair.snapshot() == js._fair.snapshot()
        _REF[chunked] = ref, ts.stats.tokens_out, ts._fair.snapshot()
    return _REF[chunked]


def _serve_to_crash(srv, reqs, crash):
    """True when the CrashPlan fired; False when the run ended first."""
    try:
        submit_all(srv, reqs)
        srv.run()
    except crash:
        srv._ck.wait()      # a killed process's writer dies with it
        return True
    return False


def test_cases_cover_both_modes_and_tails():
    assert {c[1] for c in CASES} == {True, False}
    assert {c[3] for c in CASES} == {True, False}


@pytest.mark.parametrize("crash_at,chunked,snapshot_every,torn_tail", CASES)
def test_crash_restore_is_exactly_once_and_bitwise(
        tmp_path, crash_at, chunked, snapshot_every, torn_tail):
    ref, ref_tokens, ref_vt = _reference(chunked)
    jkw, tkw = _tenants()
    js, ts = durable_pair(tmp_path, crash_at, snapshot_every=snapshot_every,
                          jax_kw=jkw, torch_kw=tkw, **_kw(chunked))
    jr, tr = _reqs(5, tenant=_acme_bulk)
    crashed = _serve_to_crash(js, jr, JaxSimulatedCrash)
    assert _serve_to_crash(ts, tr, SimulatedCrash) == crashed
    if not crashed:         # finished before the crash point
        return
    if torn_tail:           # the dying process half-wrote one more record
        for srv in (js, ts):
            with open(srv.durable.journal_path, "ab") as f:
                f.write(_HDR.pack(77, 0) + b"half-a-record")
    j2, t2 = restore_both(js, ts, jax_kw=jkw, torch_kw=tkw, **_kw(chunked))
    if torn_tail:
        assert t2._journal.truncated_bytes \
            == j2._journal.truncated_bytes > 0
    j2.run()
    t2.run()
    case = (crash_at, chunked, snapshot_every, torn_tail)
    for srv, reqs in ((j2, jr), (t2, tr)):
        got = {rid: list(r.out) for rid, r in srv.restored_requests.items()}
        for r in reqs:
            assert got.get(r.rid, list(r.out)) == ref[r.rid], (case, r.rid)
        assert (srv.stats.tokens_out + srv.stats.replayed_tokens
                == ref_tokens), case
        assert srv._fair.snapshot() == ref_vt, case
        for r in srv.restored_requests.values():
            assert len(r.out) == r.max_new_tokens     # exactly once
    assert_durable_stats(j2.stats, t2.stats)
