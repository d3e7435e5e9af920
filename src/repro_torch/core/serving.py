"""Continuous-batching serving engine — Synergy's scheduler at request
granularity.

The paper's heterogeneous job mix maps directly onto LLM serving: PREFILL
requests are large compute-bound conv-as-GEMM job sets (the CNN front-end
of the SoC — every prompt token becomes one frame through a
:mod:`repro_torch.configs.paper_cnns` network, lowered to im2col + GEMM
exactly like §3.1.1), DECODE steps are small memory-bound jobs.  Both are
expressed as engine job classes (:class:`PrefillJob` / :class:`DecodeJob`)
whose :class:`JobSet` views feed the same
:class:`~repro_torch.engines.Dispatcher` every other GEMM in the framework
uses, so per-step engine routing and busy-time accounting come from the
shared registry cost models.

Batching and asynchrony:

* **Admission waves** — ``step()`` admits *every* pending request up to the
  free slots (``min(pending, free)``) in ONE wave: one batched LM replay
  for the whole wave (per-slot masked positions keep bystanders
  untouched), one stacked frame batch through the conv front-end, ONE
  im2col gather per conv layer (:func:`repro_torch.core.im2col.im2col_wave`).
* **Coalesced decode** — the per-step decode folds every live slot's
  per-layer FFN GEMM into ONE runtime submission whose row-panel split
  amortizes dispatch overhead; when the model params expose stacked FFN
  weights (``blocks.mlp.wi``), the REAL per-layer ``wi`` matrices are
  stacked along n into one ``(d_model, n_layers·2·d_ff)`` weight (a proxy
  weight remains the fallback for families without a dense FFN stack).
  ``decode_mode="per-slot"`` keeps the sequential per-slot loop as the
  measured baseline (bitwise-identical output — the int32-partial int8
  path is exact integer math, and the tile kernel's fp32 row reductions
  are row-independent: it picks its path by (n, k, dtype), never by m).
* **In-flight window** — runtime submissions are reaped through a bounded
  FIFO (``max_inflight``), so submissions of step *t* overlap compute of
  step *t−1*; completion is reaped in submission order, and the activation
  calibrator is fed at REAP time from a device-side ``max|a|`` launched at
  submit (one host read per reaped decode, none at submit).

Dataflow-graph prefill: the wave's conv front-end is ONE
:meth:`~repro_torch.soc.SynergyRuntime.submit_graph` DAG — layer *l+1*'s
im2col gather is a graph node gated on layer *l*'s GEMM.  With
``prefill_chunk_macs`` set, the wave's graph is split into bounded-cost
chunks and the LM prompt replay into bounded token quanta, and ``step()``
interleaves one chunk with the coalesced decode GEMM.

On the card: the server lives on one device (``device=``, the card by
default) with its params, caches and runtime.  ``Request.tokens`` stay on
the CPU; a wave's prompt tokens, replay positions and admitted slots cross
to the card in ONE copy, and each decode step's tokens, positions and live
token ids in one more.  ``decode_step`` writes the caches IN PLACE, so the
server zeroes an admitted wave's slots in place and keeps no view of a
cache tensor across steps.  Reaped runtime results are merged on the
server thread's stream (the stream it submitted from) and graph values on
the default stream, so the host reads them in stream order.

Durability (``durable=``): every accepted request and emitted token goes
to a write-ahead journal before it is visible, and the server's state is
snapshotted through :class:`~repro_torch.checkpoint.Checkpointer` on a
step cadence (:mod:`repro_torch.soc.durable`).  A snapshot reaps the
in-flight window first, so the caches, ``slot_pos`` and the journal offset
describe one state; the Checkpointer copies the card's tensors to the host
after everything queued on the card has run.  :meth:`SynergyServer.
restore` writes the saved caches back IN PLACE (``copy_`` into the
server's own tensors) and re-executes the journal suffix, holding every
recomputed token bitwise against its record.

Cache discipline (continuous batching): every step passes PER-SLOT
positions to ``decode_step`` — a slot's K/V rows are written only at that
slot's own position, and slots marked ``-1`` (idle, or bystanders during
another request's prefill) are never written at all.  Chunked prefill
preserves this bitwise: replay quanta touch only the admitted wave's
slots, decode steps touch only live slots, and the two sets are disjoint
until the replay finalizes.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.engines import CAP_INT8, Dispatcher, Engine, find_engine
from repro_torch.obs.flightrec import FlightRecorder
from repro_torch.obs.trace import get_default_tracer
from repro_torch.soc.durable import (CrashPlan, Durability, RequestJournal,
                                     RestoreMismatch, SimulatedCrash,
                                     array_to_meta, load_snapshot,
                                     meta_to_array, register_server)
from repro_torch.soc.qos import AdmissionRejected, Tenant
from repro_torch.soc.qos_policy import (PREFILL_PRIORITY_OFFSET, FairShare,
                                        QosTag)

from .im2col import im2col_wave
from .job import JobSet, chunk_by_macs

__all__ = ["Request", "PrefillJob", "DecodeJob", "ServeStats",
           "TenantStats", "ServeTimeoutError", "SynergyServer"]

#: tile for the serving-side job accounting (decode GEMMs are tiny; the
#: paper-faithful TS=32 keeps their jobsets non-degenerate)
_SERVE_TILE = 32


class ServeTimeoutError(RuntimeError):
    """A runtime submission missed the server's ``submit_timeout``.

    Carries the jobset name, the per-engine accounting booked so far, and
    the affected request/tenant identity (``rids``/``tenants``) — so the
    operator sees WHICH submission stalled, how much of it each engine
    had already executed, and WHOSE traffic it was — not a bare futures
    error."""

    def __init__(self, jobset_name: str, timeout: float, accounting: dict,
                 rids: Sequence[int] = (), tenants: Sequence[str] = ()):
        self.jobset_name = jobset_name
        self.timeout = timeout
        self.accounting = dict(accounting)
        self.rids = tuple(rids)
        self.tenants = tuple(t for t in tenants if t)
        done = {name: a.get("jobs", 0) for name, a in self.accounting.items()}
        who = ""
        if self.rids:
            who = f" [rids={list(self.rids)}"
            who += (f" tenants={sorted(set(self.tenants))}]"
                    if self.tenants else "]")
        super().__init__(
            f"serving submission {jobset_name!r} not done in {timeout}s "
            f"(per-engine jobs completed so far: {done or 'none'}){who}")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: torch.Tensor       # (prompt_len,) int32, on the CPU
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    #: tenant name (required on a tenanted server; ignored otherwise)
    tenant: Optional[str] = None
    #: per-request SLO deadline in seconds from submission (overrides the
    #: tenant class default; None = the class default / no deadline)
    deadline_s: Optional[float] = None
    #: stamped by the server: monotonic submit instant, resolved absolute
    #: deadline, and the instant the last token was emitted — always
    #: recorded (QoS or not) so attainment is computable on ANY server
    submitted_at: float = 0.0
    deadline_at: float = math.inf
    done_at: Optional[float] = None


# ---------------------------------------------------------------------------
# Engine job classes: the prefill/decode split, dispatcher-visible
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrefillJob:
    """Admit one WAVE of requests: the wave's frames through the conv
    front-end, as real conv-as-GEMM JobSets (one per CONV layer, batched
    over every frame of every admitted request — no proxy GEMM)."""

    wave: int
    rids: tuple[int, ...]
    slots: tuple[int, ...]
    n_frames: int
    cnn: object                # repro_torch.models.cnn.CNNConfig

    kind = "prefill"

    def jobsets(self) -> list[JobSet]:
        """The wave's per-CONV-layer im2col GEMM JobSets — the same
        shapes :func:`repro_torch.models.cnn.build_simnet` exports to the
        DES, so server prefill busy-seconds and simulator busy-seconds read
        one cost model over one job decomposition."""
        from repro_torch.models.cnn import conv_jobsets
        return [js for _, js in
                conv_jobsets(self.cnn, self.n_frames,
                             name_prefix=f"prefill/w{self.wave}/")]


@dataclasses.dataclass(frozen=True)
class DecodeJob:
    """Advance every live slot one token: ONE coalesced memory-bound job
    set covering the whole live batch.  With real stacked FFN weights the
    GEMM is ``(live, d_model) @ (d_model, n_layers·ffn_cols)`` (per-layer
    ``wi`` stacked along n); the proxy fallback stacks per-layer GEMMs
    along m (``ffn_cols is None``)."""

    step: int
    slots: tuple[int, ...]     # live slot indices this step serves
    d_model: int
    n_layers: int
    ffn_cols: Optional[int] = None   # per-layer FFN width (2·d_ff) | None

    kind = "decode"

    def jobset(self) -> JobSet:
        if self.ffn_cols is not None:
            return JobSet.for_gemm(
                self.step, len(self.slots), self.n_layers * self.ffn_cols,
                self.d_model, _SERVE_TILE, name=f"decode/s{self.step}")
        return JobSet.for_gemm(self.step, len(self.slots) * self.n_layers,
                               4 * self.d_model, self.d_model, _SERVE_TILE,
                               name=f"decode/s{self.step}")


@dataclasses.dataclass
class TenantStats:
    """Per-tenant serving counters (``ServeStats.tenants[name]``) — the
    attribution surface for QoS failures: whose tokens, whose queue-wait,
    whose deadlines."""

    admitted: int = 0
    rejected: int = 0
    prefills: int = 0
    tokens_out: int = 0
    queue_wait_s: float = 0.0
    max_queue_wait_s: float = 0.0
    deadline_hits: int = 0
    deadline_misses: int = 0
    #: decode steps this tenant's slots ran int8-degraded (shed ladder)
    degraded_steps: int = 0

    @property
    def deadline_attainment(self) -> float:
        n = self.deadline_hits + self.deadline_misses
        return self.deadline_hits / n if n else 1.0


@dataclasses.dataclass
class ServeStats:
    engine_steps: int = 0
    prefills: int = 0
    #: admission waves executed (prefills / prefill_waves = mean wave size)
    prefill_waves: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    #: deepest the async in-flight window got (0 = fully synchronous)
    inflight_peak: int = 0
    #: bounded-cost prefill chunks executed (conv graph chunks + LM replay
    #: quanta) — 0 in legacy blocking-admission mode
    prefill_chunks: int = 0
    #: engine steps where live decoders sat idle behind a blocking
    #: admission wave — chunked prefill drives this to 0
    decode_stall_steps: int = 0
    #: dispatcher accounting per job class: estimated engine-busy seconds
    job_busy_s: dict = dataclasses.field(
        default_factory=lambda: {"prefill": 0.0, "decode": 0.0})
    #: job class -> engine name the dispatcher (or the runtime's dominant
    #: executor) last routed it to
    job_engine: dict = dataclasses.field(default_factory=dict)
    #: tile jobs per PRECISION class of the engine that executed them
    #: (int8 = CAP_INT8 quantized engines; fp32 = everything else) — the
    #: serving-visible face of the precision-routing policy
    precision_jobs: dict = dataclasses.field(
        default_factory=lambda: {"int8": 0, "fp32": 0})
    #: runtime mode only: tile jobs executed / stolen across the pool
    runtime_jobs: int = 0
    runtime_steals: int = 0
    #: runtime mode only: panel re-executions absorbed by the pool's
    #: RetryPolicy (injected faults, worker deaths) — the serving-visible
    #: proof that a crash mid-wave cost retries, not requests
    runtime_retries: int = 0
    #: tenant name -> :class:`TenantStats` (tenanted servers only)
    tenants: dict = dataclasses.field(default_factory=dict)
    #: requests refused admission (queue bound hit after the shed ladder)
    admission_rejects: int = 0
    #: times the shed ladder ENGAGED (occupancy crossed the watermark)
    shed_engagements: int = 0
    #: decode steps that ran with at least one int8-degraded slot group
    shed_degraded_steps: int = 0
    #: tokens recomputed from the journal during a restore's replay —
    #: already delivered by the crashed process, NOT fresh throughput
    #: (the no-double-count invariant: restored ``tokens_out`` +
    #: ``replayed_tokens`` equals the uninterrupted run's ``tokens_out``)
    replayed_tokens: int = 0
    #: runtime/dispatcher tile jobs executed under replay accounting
    replayed_jobs: int = 0
    #: crash-consistent snapshots taken (cadence + close())
    snapshots: int = 0
    #: successful snapshot+journal restores this ServeStats survived
    restores: int = 0

    @property
    def slot_efficiency(self) -> float:
        return self.tokens_out / max(1, self.decode_steps)


@dataclasses.dataclass
class _Inflight:
    """One outstanding serving submission in the reap window."""

    kind: str                       # "prefill" | "decode"
    futures: list
    graph: object = None            # GraphFuture (real conv prefill DAG)
    cal_engine: object = None       # engine whose calibrator reap feeds
    amax: object = None             # device-side max|acts| (decode)
    cal_key: Optional[tuple] = None  # (k, n) batch-shape key
    layout: Optional[tuple] = None   # (live, n_layers) result stitching
    wide: bool = False               # real-FFN n-stacked decode layout
    #: request/tenant identity for timeout attribution
    rids: tuple = ()
    tenant_names: tuple = ()
    #: shed-ladder row partition: (normal_rows, degraded_rows) index lists
    #: into the live layout when decode split into two class submissions
    groups: Optional[tuple] = None


@dataclasses.dataclass
class _ConvProgress:
    """The chunked conv front-end of one admission wave: remaining
    ``(steps, jobsets)`` chunks plus the carry between them (chunk *c+1*'s
    first gather reshapes chunk *c*'s flat GEMM output)."""

    wave: int
    chunks: list                    # remaining [(steps, jobsets), ...]
    x: torch.Tensor                 # carry: frames | previous flat output
    in_shape: Optional[tuple]       # (N, H, W, C) restore for the carry
    n_frames: int
    hint: Optional[str]
    total: int = 0                  # chunks at construction (for naming)
    idx: int = 0                    # next chunk index
    fut: object = None              # outstanding GraphFuture
    qos: Optional[QosTag] = None    # the wave's prefill-class tag
    rids: tuple = ()                # timeout attribution
    tenant_names: tuple = ()

    @property
    def done(self) -> bool:
        return self.fut is None and not self.chunks


@dataclasses.dataclass
class _PrefillProgress:
    """One admission wave in flight under chunked prefill: the staged LM
    replay tensors (on the server's device) plus the conv-chunk chain.
    ``step()`` advances one bounded quantum per call and runs decode in the
    same step."""

    wave: list                      # [(req, slot, toks), ...]
    lens: list
    span: int
    tok: torch.Tensor               # (span, slots, 1) int32 replay tokens
    pos: torch.Tensor               # (span, slots) int32, -1 = bystander
    conv: Optional[_ConvProgress]
    last_row: dict = dataclasses.field(default_factory=dict)
    tok_i: int = 0
    finalized: bool = False


def _leaves(tree):
    """A tree's tensors, dict keys in sorted order (``repro``'s leaf order,
    which numbers a snapshot's ``cache_NNNN`` leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


class SynergyServer:
    """cfg: reduced/real ArchConfig; params: model params on ``device``.

    slots: decode batch size (static); max_len: cache depth;
    prefill_cnn: the :class:`~repro_torch.models.cnn.CNNConfig` whose CONV
    layers are the prefill front-end (default: the paper's MNIST net);
    admission: ``"wave"`` admits min(pending, free slots) per step,
    ``"single"`` keeps the legacy one-request-per-step baseline;
    decode_mode: ``"batched"`` coalesces the live slots into one runtime
    GEMM, ``"per-slot"`` submits one GEMM per slot (the baseline);
    max_inflight: bound of the async submit/reap window (0 = synchronous);
    submit_timeout: seconds a runtime submission may stay outstanding
    before :class:`ServeTimeoutError`;
    prefill_chunk_macs: when set, split each admission wave's conv graph
    and LM replay into chunks of roughly this many MACs and interleave
    them with decode — ``None`` keeps the legacy blocking admission;
    keep_decode_outputs: retain each step's reaped decode-GEMM output in
    ``decode_gemm_outputs`` (canonical (live, n_layers, n_cols) layout
    in BOTH decode modes — how the bitwise-identity tests compare them);
    tenants: :class:`repro_torch.soc.qos.Tenant` list — enables
    multi-tenant QoS: per-tenant bounded queues, weighted fair admission
    (:class:`~repro_torch.soc.qos_policy.FairShare`), QoS tags on every
    runtime submission (decode at class priority, prefill one notch
    below — see ``PREFILL_PRIORITY_OFFSET``), the load-shedding ladder,
    and per-tenant :class:`TenantStats`; ``None`` keeps the untenanted
    FIFO server;
    max_pending: pending-queue bound — server-wide without tenants,
    per-tenant default (each tenant's own ``max_pending`` overrides)
    with them; overflow raises :class:`~repro_torch.soc.qos.
    AdmissionRejected` with a cost-model retry-after (``None`` =
    unbounded);
    cnn_params: the prefill CNN's parameters (``repro``'s
    ``init_cnn(prefill_cnn, jax.random.key(0))`` carried over through
    :func:`repro_torch.models.cnn.params_from_jax`); None draws them from
    a ``torch.Generator`` seeded 0 on ``device``;
    decode_weight: the proxy decode weight ``(d_model, 4·d_model)`` for
    families with no dense FFN stack (``repro`` draws it from
    ``jax.random.key(0xD0)``); None draws it from a ``torch.Generator``
    seeded 0xD0 on ``device``; the real-FFN weight always comes from
    ``params``;
    device: where the server, its params, caches and runtime live (the
    card by default; raises without one);
    durable: :class:`~repro_torch.soc.durable.Durability` — write-ahead
    journal every accepted request and emitted token, snapshot server
    state through :class:`~repro_torch.checkpoint.Checkpointer` every
    ``snapshot_every`` steps, and enable :meth:`restore` / :meth:`close`
    / SIGTERM drain; ``None`` keeps the ephemeral server;
    crash_plan: :class:`~repro_torch.soc.durable.CrashPlan` —
    deterministic test harness: raise :class:`~repro_torch.soc.durable.
    SimulatedCrash` at the start of the given engine step.
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 64,
                 prefill_len: int = 16,
                 dispatcher: Optional[Dispatcher] = None,
                 runtime=None,
                 prefill_cnn=None,
                 admission: str = "wave",
                 decode_mode: str = "batched",
                 max_inflight: int = 2,
                 submit_timeout: float = 60.0,
                 prefill_chunk_macs: Optional[int] = None,
                 keep_decode_outputs: bool = False,
                 tenants: Optional[Sequence[Tenant]] = None,
                 max_pending: Optional[int] = None,
                 tracer=None, flight_recorder=None, metrics=None,
                 durable: Optional[Durability] = None,
                 crash_plan: Optional[CrashPlan] = None,
                 cnn_params: Optional[dict] = None,
                 decode_weight: Optional[torch.Tensor] = None,
                 device: str | torch.device | None = "cuda"):
        from repro_torch.models import decode_step, init_cache
        from repro_torch.models.cnn import init_cnn
        if admission not in ("wave", "single"):
            raise ValueError(f"admission must be 'wave'|'single': {admission!r}")
        if decode_mode not in ("batched", "per-slot"):
            raise ValueError(
                f"decode_mode must be 'batched'|'per-slot': {decode_mode!r}")
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0: {max_inflight!r}")
        self.device = resolve_device(device)
        if runtime is not None and runtime.device != self.device:
            raise ValueError(f"runtime {runtime.name!r} runs on "
                             f"{runtime.device}, the server on {self.device}")
        for t in _leaves(params):
            if t.device != self.device:
                raise ValueError(f"a param is on {t.device}, the server "
                                 f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.admission = admission
        self.decode_mode = decode_mode
        self.max_inflight = max_inflight
        self.submit_timeout = submit_timeout
        self.prefill_chunk_macs = prefill_chunk_macs
        self.keep_decode_outputs = keep_decode_outputs
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = [0] * slots
        self.max_pending = max_pending
        self._qos_enabled = tenants is not None
        if self._qos_enabled:
            if not tenants:
                raise ValueError("tenants=[] — pass None for an "
                                 "untenanted server")
            names = [t.name for t in tenants]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate tenant names: {names}")
            self.tenants = {t.name: t for t in tenants}
        else:
            self.tenants = {"default": Tenant("default")}
        self._queues: dict[str, list[Request]] = {
            name: [] for name in self.tenants}
        self._fair = FairShare()
        self._shed_level = 0
        self.stats = ServeStats()
        self.dispatcher = dispatcher or Dispatcher()
        #: optional repro_torch.soc.SynergyRuntime — prefill/decode jobsets
        #: become runtime submissions (tile jobs spread by stealing)
        self.runtime = runtime
        if runtime is not None:
            runtime.start()
        # observability: share the runtime's tracer/flight recorder so one
        # tracer covers engine, graph, serving, and admission tracks; with
        # no tracer anywhere every emit site is one attribute check
        if tracer is None:
            tracer = getattr(runtime, "_tracer", None)
            if tracer is None:
                tracer = get_default_tracer()
        self._tracer = tracer
        if flight_recorder is None:
            flight_recorder = getattr(runtime, "_flight", None)
            if flight_recorder is None and tracer is not None:
                flight_recorder = FlightRecorder(tracer)
        self._flight = flight_recorder
        #: optional MetricsRegistry: the ONLY per-observation instrument
        #: (per-tenant queue-wait histogram) — everything else is view-fed
        self._metrics = metrics
        self._qwait_hist = (metrics.histogram(
            "repro_tenant_queue_wait_seconds",
            "admission queue wait per tenant", ("tenant",))
            if metrics is not None else None)
        if prefill_cnn is None:
            from repro_torch.configs.paper_cnns import MNIST
            prefill_cnn = MNIST
        self.prefill_cnn = prefill_cnn
        if cnn_params is None:
            cnn_params = init_cnn(prefill_cnn, self._generator(0),
                                  device=self.device)
        self._cnn_params = cnn_params
        self._decode_w = self._build_decode_weight(cfg, params,
                                                   decode_weight)
        #: slots reserved by an in-flight chunked admission: not live yet
        #: (decode skips them) and not free (admission skips them)
        self._prefilling: set[int] = set()
        self._progress: Optional[_PrefillProgress] = None
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self.decode_gemm_outputs: list = []

        # durability: journal + checkpointer + replay/drain flags.  The
        # flags exist on EVERY server (one attribute check per site);
        # only a Durability allocates the journal and checkpointer.
        self.durable = durable
        self._crash_plan = crash_plan
        self._journal: Optional[RequestJournal] = None
        self._ck: Optional[Checkpointer] = None
        self._replaying = False
        self._replay_q: Optional[collections.deque] = None
        self._closing = False
        self._drain_requested = False
        #: rid -> Request rebuilt by restore() (snapshot + journal) — the
        #: restored analog of the caller-held Request objects, since the
        #: crashed process's objects died with it
        self.restored_requests: dict[int, Request] = {}
        if durable is not None:
            self._journal = RequestJournal(durable.journal_path,
                                           fsync=durable.fsync)
            self._ck = Checkpointer(durable.snapshot_dir,
                                    keep=durable.keep,
                                    async_write=durable.async_snapshots)
            register_server(self)
        self._decode = (
            lambda p, c, t, pos: decode_step(cfg, p, c, t, pos))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- requests
    @property
    def pending(self) -> list[Request]:
        """Untenanted servers expose the REAL pending list (mutable, the
        legacy surface); tenanted servers return a flattened snapshot of
        every tenant queue — mutate through submit()/admission there."""
        if not self._qos_enabled:
            return self._queues["default"]
        return [r for q in self._queues.values() for r in q]

    def _tstats(self, name: str) -> TenantStats:
        return self.stats.tenants.setdefault(name, TenantStats())

    def submit(self, req: Request) -> None:
        """Admit one request into its tenant's pending queue.

        Stamps ``submitted_at`` and resolves the absolute ``deadline_at``
        (request ``deadline_s`` overrides the tenant class default) on
        EVERY server, so attainment is computable against an untenanted
        FIFO baseline too.  Tenanted servers enforce the per-tenant bound
        (``Tenant.max_pending`` falling back to the server's
        ``max_pending``) and raise :class:`~repro_torch.soc.qos.
        AdmissionRejected` with a cost-model retry-after when it is hit —
        AFTER the shed ladder has already engaged at the occupancy
        watermark.  An unknown tenant raises ``KeyError``."""
        if self._closing:
            name = req.tenant or "default"
            raise AdmissionRejected(name, self._retry_after(name),
                                    "server closing")
        now = time.monotonic()
        req.submitted_at = now
        if not self._qos_enabled:
            dl = req.deadline_s
            req.deadline_at = now + dl if dl is not None else math.inf
            q = self._queues["default"]
            if (self.max_pending is not None
                    and len(q) >= self.max_pending):
                raise self._reject("default", req)
            self._journal_submit(req)
            q.append(req)
            return
        if req.tenant not in self.tenants:
            raise KeyError(f"unknown tenant {req.tenant!r}; known: "
                           f"{sorted(self.tenants)}")
        t = self.tenants[req.tenant]
        dl = (req.deadline_s if req.deadline_s is not None
              else t.qos.deadline_s)
        req.deadline_at = now + dl if dl is not None else math.inf
        self._update_shed()
        q = self._queues[t.name]
        bound = (t.max_pending if t.max_pending is not None
                 else self.max_pending)
        if bound is not None and len(q) >= bound:
            self._tstats(t.name).rejected += 1
            raise self._reject(t.name, req)
        self._journal_submit(req)
        q.append(req)

    def _reject(self, tname: str, req: Request) -> AdmissionRejected:
        """Book + trace + flight-record one admission rejection and
        return the exception for the caller to raise."""
        self.stats.admission_rejects += 1
        retry = self._retry_after(tname)
        tr = self._tracer
        if tr is not None:
            tr.emit("admission", "admission", outcome="rejected",
                    tenant=tname, rid=req.rid, retry_after_s=retry)
        if self._flight is not None:
            self._flight.dump(
                "admission_rejected", stats=self.stats,
                context={"tenant": tname, "rid": req.rid,
                         "retry_after_s": retry,
                         "queued": len(self._queues.get(tname, ()))})
        return AdmissionRejected(tname, retry)

    def _retry_after(self, tname: str) -> float:
        """Cost-model estimate of when this tenant's queue frees a spot:
        the queued requests' remaining tokens through the dispatcher's
        decode estimate, over the slot parallelism."""
        q = self._queues.get(tname, [])
        js = DecodeJob(0, (0,), self.cfg.d_model, self.cfg.n_layers,
                       self._decode_ffn_cols).jobset()
        try:
            eng = self.dispatcher.select(js, job_class="decode",
                                         device=self.device)
            per_tok = eng.estimate(js, self.device)
        except RuntimeError:
            per_tok = 1e-3
        toks = sum(r.max_new_tokens for r in q) or 1
        return per_tok * toks / max(1, self.slots)

    def _update_shed(self) -> None:
        """The load-shedding ladder's occupancy trigger, with hysteresis:
        ENGAGE level 1 (sheddable tenants' decode degrades to int8-only
        via the ``decode_degraded`` job class) when bounded queues reach
        80% of capacity; disengage below 40%.  Unbounded tenancy never
        sheds — there is no overload signal to act on."""
        if not self._qos_enabled:
            return
        cap = tot = 0
        for name, t in self.tenants.items():
            bound = (t.max_pending if t.max_pending is not None
                     else self.max_pending)
            if bound is None:
                continue
            cap += bound
            tot += len(self._queues[name])
        if cap == 0:
            self._shed_level = 0
            return
        occ = tot / cap
        if self._shed_level == 0 and occ >= 0.8:
            self._shed_level = 1
            self.stats.shed_engagements += 1
            tr = self._tracer
            if tr is not None:
                tr.emit("shed", "admission", level=1, occupancy=occ)
        elif self._shed_level == 1 and occ < 0.4:
            self._shed_level = 0
            tr = self._tracer
            if tr is not None:
                tr.emit("shed", "admission", level=0, occupancy=occ)

    def reset_stats(self) -> None:
        """Fresh counters (benchmark repetitions reuse a warmed server)."""
        self.stats = ServeStats()
        self.decode_gemm_outputs = []

    # --------------------------------------------------------------- engine
    def step(self) -> bool:
        """One engine step.  Legacy mode (``prefill_chunk_macs=None``):
        admit a prefill WAVE if there is capacity, else advance the whole
        decode batch one token.  Chunked mode: advance the in-flight
        admission by one bounded chunk AND decode the live batch in the
        SAME step.  Returns True if any work was done (in-flight
        submissions may still be outstanding — ``run()``/``drain()``
        reap them).  Durable servers: fires a due :class:`CrashPlan`
        BEFORE any work (the boundary a between-steps SIGKILL lands on),
        engages a requested drain, and snapshots on the
        ``snapshot_every`` cadence after the step's work."""
        if (self._crash_plan is not None and not self._replaying
                and self._crash_plan.due(self.stats.engine_steps)):
            plan, self._crash_plan = self._crash_plan, None
            raise SimulatedCrash(f"CrashPlan(at_step={plan.at_step})")
        if self._drain_requested:
            self._closing = True
        worked = self._step_inner()
        every = self.durable.snapshot_every if self.durable else 0
        if (self._ck is not None and not self._replaying and every
                and self.stats.engine_steps % every == 0):
            self.snapshot()
        return worked

    def _step_inner(self) -> bool:
        self.stats.engine_steps += 1
        if self.prefill_chunk_macs is None:
            live = any(r is not None for r in self.slot_req)
            if self._admit_wave():
                if live:
                    self.stats.decode_stall_steps += 1
                return True
            if live:
                self._do_decode()
                return True
            return False
        worked = False
        if (self._progress is not None and self._replaying
                and self._replay_next_is_admit()):
            # replay alignment: the recorded run's chunk chain had already
            # completed (conv graph timing is wall-clock, token values are
            # not) and the next journaled event is an admission — force the
            # chain to the same boundary so the wave slots free up now
            self._force_finish_progress()
            worked = True
        if self._progress is not None:
            worked = self._advance_prefill(self._progress) or worked
        elif self._admit_wave():
            worked = True
        if any(r is not None for r in self.slot_req):
            self._do_decode()
            worked = True
        return worked

    def run(self, until_drained: bool = True, max_steps: int = 10_000):
        while max_steps > 0:
            if self._drain_requested:
                # SIGTERM (or request_drain) landed: graceful close —
                # finish live generations, snapshot, release the pool
                self.close()
                return self.stats
            if not self.step():
                break
            max_steps -= 1
        self.drain()
        return self.stats

    def drain(self) -> ServeStats:
        """Finish any in-flight chunked admission (replay remainder plus
        the conv chunk chain, blocking under ``submit_timeout``), then
        reap every outstanding in-flight submission."""
        self._force_finish_progress()
        while self._inflight:
            self._reap_one()
        return self.stats

    # ------------------------------------------------------------ admission
    def _pick_requests(self, n: int) -> list[tuple[str, Request]]:
        """Weighted fair admission: up to ``n`` ``(tenant, request)``
        pairs, chosen head-of-queue by :class:`~repro_torch.soc.qos_policy.
        FairShare` (priority first, then stride virtual time, deadline as
        the tie-break).  Peeks only — the caller validates the whole wave
        before committing the pops (an aborted wave leaves a little
        virtual-time drift, never a lost request)."""
        taken = {name: 0 for name in self._queues}
        picked: list[tuple[str, Request]] = []
        while len(picked) < n:
            cands = []
            for name, q in self._queues.items():
                i = taken[name]
                if i < len(q):
                    t = self.tenants[name]
                    cands.append((name, t.qos.priority, q[i].deadline_at,
                                  t.qos.weight))
            if not cands:
                break
            name = self._fair.pick(cands)
            picked.append((name, self._queues[name][taken[name]]))
            taken[name] += 1
            self._fair.charge(name, self.tenants[name].qos.weight)
        return picked

    def _admit_wave(self) -> int:
        """Admit ``min(pending, free slots)`` requests in ONE wave (one
        batched LM replay + one conv-front-end batch); ``"single"``
        admission caps the wave at 1 (the legacy baseline).  Tenanted
        servers pick wave members by weighted fair share instead of
        global FIFO."""
        if self._closing:
            return 0
        if self._replaying:
            return self._replay_admit()
        free = [i for i, r in enumerate(self.slot_req)
                if r is None and i not in self._prefilling]
        if not self._qos_enabled:
            q = self._queues["default"]
            n = min(len(q), len(free))
            if self.admission == "single":
                n = min(n, 1)
            if n == 0:
                return 0
            # validate BEFORE popping: a bad request mid-wave must not
            # drop the wave members already taken off the pending queue
            wave = []
            for j, slot in enumerate(free[:n]):
                req = q[j]
                toks = req.tokens[: self.prefill_len]
                if toks.shape[0] == 0:
                    raise ValueError(f"request {req.rid}: empty prompt")
                wave.append((req, slot, toks))
            del q[:n]
            self._journal_admit(wave)
            tr = self._tracer
            if tr is not None:
                tr.emit("admission", "admission", outcome="admitted",
                        n=n, rids=[r.rid for r, _, _ in wave])
            self._do_prefill_wave(wave)
            return n
        navail = len(free)
        if self.admission == "single":
            navail = min(navail, 1)
        if navail == 0:
            return 0
        picked = self._pick_requests(navail)
        if not picked:
            return 0
        wave = []
        for (tname, req), slot in zip(picked, free):
            toks = req.tokens[: self.prefill_len]
            if toks.shape[0] == 0:
                raise ValueError(f"request {req.rid}: empty prompt")
            wave.append((req, slot, toks))
        now = time.monotonic()
        for tname, req in picked:
            self._queues[tname].remove(req)
            ts = self._tstats(tname)
            ts.admitted += 1
            wait = max(0.0, now - req.submitted_at)
            ts.queue_wait_s += wait
            ts.max_queue_wait_s = max(ts.max_queue_wait_s, wait)
            if self._qwait_hist is not None:
                self._qwait_hist.labels(tname).observe(wait)
        self._update_shed()
        self._journal_admit(wave)
        tr = self._tracer
        if tr is not None:
            tr.emit("admission", "admission", outcome="admitted",
                    n=len(wave), rids=[r.rid for _, r in picked],
                    tenants=[t for t, _ in picked])
        self._do_prefill_wave(wave)
        return len(wave)

    # ----------------------------------------------------------- durability
    def _journal_submit(self, req: Request) -> None:
        """WAL the accepted request BEFORE it enters its queue — after
        every admission check, so the journal holds exactly the accepted
        set (a rejected request must not be replayed)."""
        if self._journal is None or self._replaying:
            return
        self._journal.append({
            "t": "submit", "rid": int(req.rid),
            "tok": np.asarray(req.tokens, np.int64).tolist(),
            "new": int(req.max_new_tokens),
            "tenant": req.tenant, "dl": req.deadline_s})

    def _journal_admit(self, wave: list) -> None:
        """WAL one committed admission wave (rid -> slot assignment) —
        live admission timing is wall-clock-dependent (conv completion,
        submission interleave), so replay FORCES these assignments
        instead of re-running the scheduler."""
        if self._journal is None or self._replaying:
            return
        self._journal.append({
            "t": "admit",
            "wave": [[int(r.rid), int(slot)] for r, slot, _ in wave]})

    def _journal_emit(self, kind: str, emits: list) -> bool:
        """WAL one token-emission batch, or — during replay — verify the
        recomputation bitwise against the journaled record.  Returns True
        when the emission was a replay (already delivered; callers must
        not re-book throughput).  An exhausted replay queue mid-step
        means the crash interrupted that step: the events from here on
        were never delivered, so they journal (and book) fresh."""
        if self._journal is None:
            return False
        rec = {"t": kind, "e": emits}
        if self._replaying and self._replay_q:
            exp = self._replay_q.popleft()
            if exp.get("t") != kind or exp.get("e") != emits:
                self._restore_mismatch(exp, rec)
            return True
        self._journal.append(rec)
        return False

    def _restore_mismatch(self, expected, got) -> None:
        if self._flight is not None:
            self._flight.dump("restore_mismatch", stats=self.stats,
                              context={"expected": expected, "got": got})
        raise RestoreMismatch(expected, got)

    def _replay_next_is_admit(self) -> bool:
        return (bool(self._replay_q)
                and self._replay_q[0].get("t") == "admit")

    def _take_queued(self, rid: int):
        """Remove and return the pending request with ``rid`` (journal
        replay admits by identity, not queue position)."""
        for name, q in self._queues.items():
            for i, r in enumerate(q):
                if r.rid == rid:
                    del q[i]
                    return r, name
        return None, None

    def _replay_admit(self) -> int:
        """Force the next journaled admission wave: pop each recorded rid
        from its queue into its recorded slot.  FairShare is charged in
        the recorded wave order (identical virtual times afterwards), but
        ``pick`` never runs — the journal IS the schedule.  Per-tenant
        throughput stats are NOT re-booked (replay recomputes state, it
        does not re-serve)."""
        q = self._replay_q
        if not q or q[0].get("t") != "admit":
            return 0
        rec = q.popleft()
        if self._qos_enabled:
            # the recorded pick entered every then-pending tenant at the
            # vt floor — apply the same rule BEFORE popping wave members
            self._fair.join(name for name, pq in self._queues.items()
                            if pq)
        wave = []
        for rid, slot in rec["wave"]:
            rid, slot = int(rid), int(slot)
            req, tname = self._take_queued(rid)
            if (req is None or self.slot_req[slot] is not None
                    or slot in self._prefilling):
                self._restore_mismatch(
                    rec, {"rid": rid, "slot": slot,
                          "queued": req is not None,
                          "slot_busy": self.slot_req[slot] is not None})
            wave.append((req, slot, req.tokens[: self.prefill_len]))
            if (self._qos_enabled and tname is not None
                    and tname in self.tenants):
                self._fair.charge(tname, self.tenants[tname].qos.weight)
        if self._qos_enabled:
            self._update_shed()
        self._do_prefill_wave(wave)
        return len(wave)

    def _resubmit(self, rec: dict) -> None:
        """Replay one journaled submit: rebuild the Request and queue it
        directly — the crashed process already ran the admission checks,
        so bounds are bypassed (replay must never reject)."""
        req = Request(rid=int(rec["rid"]),
                      tokens=torch.tensor(rec["tok"], dtype=torch.int32),
                      max_new_tokens=int(rec["new"]),
                      tenant=rec.get("tenant"),
                      deadline_s=rec.get("dl"))
        self._stamp_restored(req)
        name = (req.tenant if self._qos_enabled and req.tenant
                else "default")
        self._queues.setdefault(name, []).append(req)
        if self._qos_enabled:
            self._update_shed()
        self.restored_requests[req.rid] = req

    def _stamp_restored(self, req: Request) -> None:
        """Fresh submit/deadline stamps for a restored request — monotonic
        instants do not survive a process boundary, so SLO clocks restart
        at the restore (the crash pauses deadlines, it does not consume
        them)."""
        now = time.monotonic()
        req.submitted_at = now
        dl = req.deadline_s
        if (dl is None and self._qos_enabled
                and req.tenant in self.tenants):
            dl = self.tenants[req.tenant].qos.deadline_s
        req.deadline_at = now + dl if dl is not None else math.inf

    def _force_finish_progress(self) -> None:
        """Complete the in-flight chunked admission NOW (blocking): drain
        the remaining replay quanta and conv chunk chain.  Used by replay
        alignment and by ``drain()``."""
        prog = self._progress
        if prog is None:
            return
        if prog.tok_i < prog.span:
            self._replay_span(prog, prog.tok_i, prog.span)
            prog.tok_i = prog.span
            self.stats.prefill_chunks += 1
        if not prog.finalized:
            self._finalize_replay(prog)
        conv = prog.conv
        while conv is not None and not conv.done:
            self._harvest_conv_blocking(conv)
        self._progress = None

    def _land_conv_chunk(self) -> None:
        """Land an outstanding conv chunk graph so the carry is concrete,
        but do NOT submit the next one: the chain stays at a chunk
        boundary for the next step to resume."""
        prog = self._progress
        if (prog is not None and prog.conv is not None
                and prog.conv.fut is not None):
            conv = prog.conv
            vals = self._graph_result(conv.fut, conv.rids,
                                      conv.tenant_names)
            self._book_runtime("prefill", conv.fut.accounting, conv.fut)
            conv.x = vals[-1]
            conv.fut = None

    # ----------------------------------------------- snapshots and restore
    @staticmethod
    def _req_state(req: Request) -> dict:
        return {"rid": int(req.rid),
                "tok": np.asarray(req.tokens, np.int64).tolist(),
                "new": int(req.max_new_tokens),
                "out": [int(x) for x in req.out],
                "tenant": req.tenant, "dl": req.deadline_s}

    def _req_from_state(self, st: dict) -> Request:
        req = Request(rid=int(st["rid"]),
                      tokens=torch.tensor(st["tok"], dtype=torch.int32),
                      max_new_tokens=int(st["new"]),
                      out=[int(x) for x in st["out"]],
                      tenant=st.get("tenant"),
                      deadline_s=st.get("dl"))
        self._stamp_restored(req)
        self.restored_requests[req.rid] = req
        return req

    def _snapshot_state(self) -> dict:
        """The server as a FLAT ``{key: tensor}`` Checkpointer tree: cache
        leaves, in-flight prefill tensors, and one uint8 "meta" leaf
        holding every scalar/structural field as JSON (scalars survive a
        JSON round-trip bitwise; tensors go as .npy leaves).  The leaves
        are the server's own tensors: ``Checkpointer.save`` copies them."""
        state = {f"cache_{i:04d}": leaf
                 for i, leaf in enumerate(_leaves(self.cache))}
        meta: dict = {
            "version": 1,
            "journal_off": self._journal.offset(),
            "stats": dataclasses.asdict(self.stats),
            "slot_pos": [int(p) for p in self.slot_pos],
            "slots": [self._req_state(r) if r is not None else None
                      for r in self.slot_req],
            "queues": {name: [self._req_state(r) for r in q]
                       for name, q in self._queues.items()},
            "prefilling": sorted(self._prefilling),
            "fair": self._fair.snapshot(),
            "shed_level": self._shed_level,
            "calibrator": None, "runtime": None, "progress": None,
        }
        cal = self._calibration_engine()
        if cal is not None and hasattr(cal, "calibrator"):
            meta["calibrator"] = cal.calibrator.export_state()
        if self.runtime is not None:
            meta["runtime"] = self.runtime.state_snapshot()
        prog = self._progress
        if prog is not None:
            pmeta = {
                "wave": [[self._req_state(r), int(slot)]
                         for r, slot, _ in prog.wave],
                "span": int(prog.span), "tok_i": int(prog.tok_i),
                "finalized": bool(prog.finalized),
                "row_slots": sorted(prog.last_row), "conv": None,
            }
            state["prog_tok"] = prog.tok
            state["prog_pos"] = prog.pos
            for slot, row in prog.last_row.items():
                state[f"prog_row_{int(slot):04d}"] = row
            conv = prog.conv
            if conv is not None and not conv.done:
                pmeta["conv"] = {
                    "wave_no": int(conv.wave), "idx": int(conv.idx),
                    "total": int(conv.total),
                    "n_frames": int(conv.n_frames),
                    "in_shape": (list(conv.in_shape)
                                 if conv.in_shape else None),
                    "rids": [int(r) for r in conv.rids],
                    "tenant_names": list(conv.tenant_names)}
                state["conv_x"] = conv.x
            meta["progress"] = pmeta
        state["meta"] = meta_to_array(meta)
        return state

    def snapshot(self) -> int:
        """Take one crash-consistent snapshot at a quiescent boundary:
        reap the async window, harvest (without advancing) an outstanding
        conv chunk graph, quiesce the pool, save through the
        Checkpointer (which holds its own host copy when this returns).
        Returns the snapshot's step id."""
        if self._ck is None:
            raise RuntimeError("snapshot() needs durable=Durability(...)")
        while self._inflight:
            self._reap_one()
        self._land_conv_chunk()
        if (self.runtime is not None
                and not self.runtime.quiesce(self.submit_timeout)):
            raise ServeTimeoutError("snapshot/quiesce", self.submit_timeout,
                                    {})
        step = self.stats.engine_steps
        self._ck.save(step, self._snapshot_state(),
                      block=not self.durable.async_snapshots)
        self.stats.snapshots += 1
        tr = self._tracer
        if tr is not None:
            tr.emit("snapshot", "serving", step=step,
                    journal_off=self._journal.offset())
        return step

    def _apply_snapshot(self, flat: dict) -> dict:
        meta = array_to_meta(flat["meta"])
        st = dict(meta["stats"])
        tstats = st.pop("tenants", {})
        self.stats = ServeStats(**st)
        self.stats.tenants = {k: TenantStats(**v)
                              for k, v in tstats.items()}
        # in place: the caches stay the server's own tensors
        with torch.inference_mode():
            for i, leaf in enumerate(_leaves(self.cache)):
                src = flat[f"cache_{i:04d}"]
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"snapshot cache_{i:04d} is {src.dtype} "
                        f"{tuple(src.shape)}, the server's {leaf.dtype} "
                        f"{tuple(leaf.shape)}")
                leaf.copy_(src)
        self.slot_pos = [int(p) for p in meta["slot_pos"]]
        self.slot_req = [self._req_from_state(s) if s is not None else None
                         for s in meta["slots"]]
        queues: dict[str, list[Request]] = {n: [] for n in self.tenants}
        for name, q in meta["queues"].items():
            queues[name] = [self._req_from_state(s) for s in q]
        self._queues = queues
        self._prefilling = {int(s) for s in meta["prefilling"]}
        self._fair.restore(meta["fair"])
        self._shed_level = int(meta["shed_level"])
        if meta.get("calibrator") is not None:
            cal = self._calibration_engine()
            if cal is not None and hasattr(cal, "calibrator"):
                cal.calibrator.import_state(meta["calibrator"])
        if meta.get("runtime") is not None and self.runtime is not None:
            self.runtime.restore_state(meta["runtime"])
        if meta.get("progress") is not None:
            self._progress = self._rebuild_progress(meta["progress"], flat)
        return meta

    def _rebuild_progress(self, pmeta: dict, flat: dict) -> _PrefillProgress:
        wave = []
        for st, slot in pmeta["wave"]:
            req = self._req_from_state(st)
            wave.append((req, int(slot), req.tokens[: self.prefill_len]))
        lens = [int(t.shape[0]) for _, _, t in wave]
        prog = _PrefillProgress(
            wave, lens, int(pmeta["span"]),
            flat["prog_tok"].to(self.device),
            flat["prog_pos"].to(self.device), None,
            tok_i=int(pmeta["tok_i"]),
            finalized=bool(pmeta["finalized"]))
        for slot in pmeta["row_slots"]:
            prog.last_row[int(slot)] = flat[
                f"prog_row_{int(slot):04d}"].to(self.device)
        if pmeta.get("conv") is not None:
            prog.conv = self._rebuild_conv(pmeta["conv"], flat, wave)
        return prog

    def _rebuild_conv(self, cmeta: dict, flat: dict,
                      wave: list) -> _ConvProgress:
        """Reconstruct the chunk chain: jobsets/steps/groups are pure
        functions of (cnn, n_frames, wave_no, chunk_macs) — recomputed,
        not stored; only the carry tensor and the cursor come from disk."""
        from repro_torch.models.cnn import conv_graph_steps
        wave_no, idx = int(cmeta["wave_no"]), int(cmeta["idx"])
        n_frames = int(cmeta["n_frames"])
        job = PrefillJob(wave_no, tuple(int(r) for r in cmeta["rids"]),
                         tuple(slot for _, slot, _ in wave),
                         n_frames=n_frames, cnn=self.prefill_cnn)
        jobsets = job.jobsets()
        steps = conv_graph_steps(self.prefill_cnn)
        groups = chunk_by_macs(jobsets, self.prefill_chunk_macs)
        hint_eng = (self._affinity_hint(jobsets[0], "prefill")
                    if jobsets else None)
        in_shape = (tuple(cmeta["in_shape"])
                    if cmeta.get("in_shape") else None)
        return _ConvProgress(
            wave_no,
            [([steps[i] for i in g], [jobsets[i] for i in g])
             for g in groups[idx:]],
            flat["conv_x"].to(self.device), in_shape, n_frames,
            hint_eng.name if hint_eng is not None else None,
            total=int(cmeta["total"]), idx=idx,
            qos=self._prefill_qos(wave), rids=job.rids,
            tenant_names=tuple(cmeta["tenant_names"]))

    @classmethod
    def restore(cls, cfg, params, *, durable: Durability, **kwargs):
        """Reconstruct a durable server from ``durable.directory``: load
        the latest snapshot, then RE-EXECUTE the journal suffix —
        submits requeue, admissions are forced into their recorded
        slots, and every recomputed token is verified bitwise against
        its journal record (:class:`~repro_torch.soc.durable.
        RestoreMismatch` + flight dump on divergence).  Replayed tokens
        book into ``replayed_tokens``; the returned server resumes
        serving with nothing lost and nothing double-served.  ``kwargs``
        are the constructor's (the pool/config must match the crashed
        server's).  The returned server's ``restore_seconds`` gives the
        wall seconds of the snapshot's load (disk to the server's
        tensors) and of the replay."""
        srv = cls(cfg, params, durable=durable, **kwargs)
        t0 = time.perf_counter()
        off = 0
        if srv._ck.latest_step() is not None:
            _, flat = load_snapshot(srv._ck)
            meta = srv._apply_snapshot(flat)
            off = int(meta["journal_off"])
        t_load = time.perf_counter() - t0
        records, _, _ = RequestJournal.scan(durable.journal_path,
                                            start=off)
        srv._replaying = True
        srv._replay_q = collections.deque(records)
        try:
            while srv._replay_q:
                while (srv._replay_q
                       and srv._replay_q[0].get("t") == "submit"):
                    srv._resubmit(srv._replay_q.popleft())
                if not srv._replay_q:
                    break
                if not srv.step():
                    srv._restore_mismatch(
                        srv._replay_q[0],
                        {"reason": "replay stalled: no work to run"})
            # replay-phase runtime work reaps under replay accounting;
            # an outstanding conv chunk lands but the chain stays at its
            # boundary for the live steps to resume
            while srv._inflight:
                srv._reap_one()
            srv._land_conv_chunk()
        finally:
            srv._replaying = False
            srv._replay_q = None
        srv.restore_seconds = {"load": t_load,
                               "replay": time.perf_counter() - t0 - t_load}
        srv.stats.restores += 1
        tr = srv._tracer
        if tr is not None:
            tr.emit("restore", "serving", journal_off=off,
                    records=len(records),
                    replayed_tokens=srv.stats.replayed_tokens,
                    **{f"{k}_s": v for k, v in srv.restore_seconds.items()})
            if srv._journal.truncated_bytes:
                tr.emit("journal", "serving", outcome="torn_tail",
                        truncated_bytes=srv._journal.truncated_bytes)
        return srv

    # ------------------------------------------------------ graceful drain
    def request_drain(self) -> None:
        """Flag a graceful drain (async-signal-safe: sets a bool; the
        serving loop engages it at its next step and ``run()`` closes)."""
        self._drain_requested = True

    def close(self, deadline_s: float = 30.0, *,
              release_pool: bool = True) -> ServeStats:
        """Graceful shutdown: stop admission, run live generations to
        completion while ``deadline_s`` allows, drain in-flight work,
        snapshot (durable servers — pending requests survive into the
        snapshot for the next ``restore()``), close the journal, and
        release the pool."""
        self._closing = True
        t0 = time.monotonic()
        while (any(r is not None for r in self.slot_req)
               or self._progress is not None):
            if time.monotonic() - t0 >= deadline_s:
                break
            if not self.step():
                break
        self.drain()
        if self._ck is not None:
            self.snapshot()
            self._ck.wait()
            self._journal.close()
        tr = self._tracer
        if tr is not None:
            tr.emit("drain", "serving", deadline_s=deadline_s,
                    live=sum(r is not None for r in self.slot_req),
                    pending=len(self.pending))
        if release_pool and self.runtime is not None:
            self.runtime.shutdown()
        return self.stats

    # ------------------------------------------------------------ internals
    @staticmethod
    def _precision_class(engine: Optional[Engine]) -> str:
        return ("int8" if engine is not None
                and CAP_INT8 in engine.capabilities else "fp32")

    def _affinity_hint(self, js: JobSet, kind: str) -> Optional[Engine]:
        """The dispatcher's policy pick for this job class on the server's
        device — the runtime queue-affinity hint (int8 for decode when one
        is registered)."""
        try:
            return self.dispatcher.select(js, job_class=kind,
                                          device=self.device)
        except RuntimeError:
            return None

    def _account_dispatch(self, kind: str, js: JobSet) -> Engine:
        """No-runtime path: route the JobSet whole to the dispatcher's
        pick and book its cost-model estimate."""
        eng = self.dispatcher.select(js, job_class=kind, device=self.device)
        if self._replaying:
            self.stats.replayed_jobs += js.num_jobs
            return eng
        est = eng.estimate(js, self.device)
        eng.telemetry.record(js, est)
        self.stats.job_busy_s[kind] += est
        self.stats.job_engine[kind] = eng.name
        self.stats.precision_jobs[self._precision_class(eng)] += js.num_jobs
        return eng

    def _book_runtime(self, kind: str, acct: dict, src=None) -> None:
        """Book one reaped runtime submission's per-engine accounting.
        ``src`` is the reaped future/graph itself, when available — its
        ``retries`` count (panels re-executed by the pool's RetryPolicy)
        rolls into ``stats.runtime_retries``."""
        if self._replaying:
            # replay recomputes state, it does not re-serve: the work is
            # real but its throughput was already delivered once
            self.stats.replayed_jobs += sum(
                a["jobs"] for a in acct.values())
            return
        if src is not None:
            self.stats.runtime_retries += getattr(src, "retries", 0)
        self.stats.job_busy_s[kind] += sum(a["est_s"] for a in acct.values())
        if acct:
            dominant = max(acct, key=lambda n: acct[n]["jobs"])
            self.stats.job_engine[kind] = dominant
        for name, a in acct.items():
            # pool engines need not be registry entries: resolve from
            # the runtime's live pool first, the registry second
            eng = self.runtime.find_engine(name) or find_engine(name)
            self.stats.precision_jobs[self._precision_class(eng)] \
                += a["jobs"]
        self.stats.runtime_jobs += sum(a["jobs"] for a in acct.values())
        self.stats.runtime_steals += sum(a["steals"] for a in acct.values())

    def _dump_timeout(self, name: str, rids, tenants) -> None:
        """Flight-record a serving timeout: event tail + runtime stats so
        the post-mortem shows WHERE the stuck submission's panels sat."""
        if self._flight is None:
            return
        rt_stats = self.runtime.stats() if self.runtime is not None else {}
        self._flight.dump(
            "serve_timeout",
            stats={"runtime": rt_stats, "serve": self.stats},
            context={"jobset": name, "rids": list(rids),
                     "tenants": list(tenants),
                     "timeout_s": self.submit_timeout})

    def _fut_result(self, fut, rids: tuple = (), tenants: tuple = ()):
        try:
            return fut.result(timeout=self.submit_timeout)
        except TimeoutError:
            self._dump_timeout(fut.jobset.name, rids, tenants)
            raise ServeTimeoutError(fut.jobset.name, self.submit_timeout,
                                    fut.accounting, rids, tenants) from None

    def _graph_result(self, gf, rids: tuple = (), tenants: tuple = ()):
        """Block on one prefill graph; a timeout CANCELS the graph —
        not-yet-started downstream nodes never launch and queued panels
        are drained — before surfacing :class:`ServeTimeoutError`."""
        try:
            return gf.result(timeout=self.submit_timeout)
        except TimeoutError:
            gf.cancel("serving submit_timeout")
            self._dump_timeout(gf.name, rids, tenants)
            raise ServeTimeoutError(gf.name, self.submit_timeout,
                                    gf.accounting, rids, tenants) from None

    # ----------------------------------------------------------- QoS tags
    def _req_tenant(self, req: Optional[Request]) -> Optional[Tenant]:
        if req is None or not self._qos_enabled:
            return None
        return self.tenants.get(req.tenant)

    def _decode_qos(self, slots: Sequence[int]) -> Optional[QosTag]:
        """The coalesced decode submission's tag: the MOST urgent live
        member wins — max priority, earliest absolute deadline."""
        if not self._qos_enabled:
            return None
        prio, dl = None, math.inf
        for s in slots:
            t = self._req_tenant(self.slot_req[s])
            if t is None:
                continue
            prio = (t.qos.priority if prio is None
                    else max(prio, t.qos.priority))
            dl = min(dl, self.slot_req[s].deadline_at)
        return None if prio is None else QosTag(prio, dl)

    def _prefill_qos(self, wave: list) -> Optional[QosTag]:
        """The wave's prefill tag: its most urgent member's class, one
        priority notch below decode (``PREFILL_PRIORITY_OFFSET``) so
        decode-class panels preempt bulk prefill at chunk boundaries."""
        if not self._qos_enabled:
            return None
        prio, dl = None, math.inf
        for req, _, _ in wave:
            t = self._req_tenant(req)
            if t is None:
                continue
            prio = (t.qos.priority if prio is None
                    else max(prio, t.qos.priority))
            dl = min(dl, req.deadline_at)
        return (None if prio is None
                else QosTag(prio + PREFILL_PRIORITY_OFFSET, dl))

    # ------------------------------------------------------ in-flight window
    def _push_inflight(self, inf: _Inflight) -> None:
        self._inflight.append(inf)
        while len(self._inflight) > self.max_inflight:
            self._reap_one()
        # peak is measured AFTER eviction: what stays outstanding past
        # the step (0 = fully synchronous, matching the field docs)
        self.stats.inflight_peak = max(self.stats.inflight_peak,
                                       len(self._inflight))

    def _reap_one(self) -> None:
        """Reap the OLDEST in-flight submission (FIFO — completions are
        booked in submission order, so per-slot accounting stays ordered),
        book its accounting, and feed the activation calibrator from the
        device-side ``max|a|`` launched at submit (its one host read).
        Results were merged on this thread's stream, so restacking them
        here is ordered after the merge without a wait."""
        inf = self._inflight.popleft()
        if inf.graph is not None:
            self._graph_result(inf.graph, inf.rids, inf.tenant_names)
            self._book_runtime(inf.kind, inf.graph.accounting, inf.graph)
        results = [self._fut_result(f, inf.rids, inf.tenant_names)
                   for f in inf.futures]
        for fut in inf.futures:
            self._book_runtime(inf.kind, fut.accounting, fut)
        if inf.kind == "decode" and inf.layout is not None:
            live, nl = inf.layout
            n_cols = inf.cal_key[1]
            if inf.wide:
                # real-FFN n-stacked layout: rows are slots already
                n_per = n_cols // nl
                if inf.groups is not None:
                    # shed-ladder split: stitch the class groups' rows
                    # back into live-slot order
                    rows: list = [None] * live
                    for g, res in zip(inf.groups, results):
                        r3 = res.reshape(len(g), nl, n_per)
                        for k, j in enumerate(g):
                            rows[j] = r3[k]
                    y = torch.stack(rows, 0)
                elif len(results) == 1:  # batched: (live, nl·n_per)
                    y = results[0].reshape(live, nl, n_per)
                else:                  # per-slot: one (1, nl·n_per) each
                    y = torch.stack([r.reshape(nl, n_per) for r in results],
                                    0)
            elif len(results) == 1:    # proxy batched: (nl·live, 4d)
                y = results[0].reshape(nl, live, n_cols).transpose(0, 1)
            else:                      # proxy per-slot: one (nl, 4d) each
                y = torch.stack(results, 0)
            if self.keep_decode_outputs:
                self.decode_gemm_outputs.append(y)
            eng = inf.cal_engine
            if (eng is not None and inf.amax is not None
                    and hasattr(eng, "observe_amax")):
                eng.observe_amax(inf.amax.item(), *inf.cal_key)

    def _calibration_engine(self) -> Optional[Engine]:
        """The live pool's quantized engine (whose calibrator gates the
        runtime's int8 split), if any."""
        if self.runtime is None:
            return None
        for name in self.runtime.engine_names:
            eng = self.runtime.find_engine(name)
            if eng is not None and hasattr(eng, "observe_amax"):
                return eng
        return None

    def _has_fp32_engine(self) -> bool:
        """Whether the pool can execute grad-safe (non-int8) prefill
        panels — real conv compute needs one; otherwise prefill books
        accounting jobsets only."""
        for name in self.runtime.engine_names:
            eng = self.runtime.find_engine(name)
            if eng is not None and CAP_INT8 not in eng.capabilities:
                return True
        return False

    def _has_int8_engine(self) -> bool:
        """Whether the pool has an int8 engine — the shed ladder's
        degraded decode tier requires one (``decode_degraded`` is a hard
        int8 job class; without the engine shedding stays at rejection
        only)."""
        if self.runtime is None:
            return False
        for name in self.runtime.engine_names:
            eng = self.runtime.find_engine(name)
            if eng is not None and CAP_INT8 in eng.capabilities:
                return True
        return False

    def _degraded_rows(self, live: Sequence[int]) -> list[int]:
        """Row indices (into ``live``) whose slot belongs to a SHEDDABLE
        tenant while the load-shed ladder is engaged — their decode steps
        are routed through the int8-only ``decode_degraded`` class so the
        fp32 pool stays free for interactive traffic."""
        self._update_shed()
        if (not self._qos_enabled or self._shed_level == 0
                or not self._has_int8_engine()):
            return []
        out = []
        for j, slot in enumerate(live):
            req = self.slot_req[slot]
            t = self.tenants.get(req.tenant) if req is not None else None
            if t is not None and t.qos.sheddable:
                out.append(j)
        return out

    # -------------------------------------------------------------- prefill
    def _wave_frames(self, toks: torch.Tensor) -> Optional[torch.Tensor]:
        """The wave's conv-front-end input: each prompt token becomes one
        (H, W, Cin) frame by tiling its embedding row — the vision-encoder
        analog (deterministic, so prefill numerics are reproducible).
        ``toks`` are the wave's token ids on the server's device.  None
        when the params carry no embedding table (accounting-only
        prefill)."""
        embed = (self.params.get("embed")
                 if isinstance(self.params, dict) else None)
        if embed is None:
            return None
        c = self.prefill_cnn
        hwc = c.input_hw * c.input_hw * c.cin
        vecs = embed[toks].to(torch.float32)              # (N, d_model)
        reps = -(-hwc // vecs.shape[1])
        flat = vecs.repeat(1, reps)[:, :hwc]
        return flat.reshape(vecs.shape[0], c.input_hw, c.input_hw, c.cin)

    def _im2col(self, x, kh, kw, stride, pad):
        """Wave gather indirection: resolves ``im2col_wave`` through THIS
        module's globals at call time, so instrumentation (tests count
        one gather per conv layer) hooks the serving module."""
        return im2col_wave(x, kh, kw, stride, pad)

    def _submit_prefill(self, job: PrefillJob,
                        frames: Optional[torch.Tensor],
                        qos: Optional[QosTag] = None,
                        tenant_names: tuple = ()) -> Optional[_ConvProgress]:
        """Route the wave's conv JobSets: a REAL im2col+GEMM dataflow
        graph through the runtime when the pool can run grad-safe panels
        (chunked into a :class:`_ConvProgress` chain when
        ``prefill_chunk_macs`` is set, else one graph reaped through the
        in-flight window), a single batched accounting submission
        (``submit_many``) otherwise, and plain dispatcher estimates
        without a runtime.  ``qos`` tags every panel with the wave's
        prefill class.  Returns the in-flight chunk chain, if any."""
        jobsets = job.jobsets()
        if not jobsets:
            return None
        if self.runtime is None:
            for js in jobsets:
                self._account_dispatch("prefill", js)
            return None
        hint_eng = self._affinity_hint(jobsets[0], "prefill")
        hint = hint_eng.name if hint_eng is not None else None
        if frames is not None and self._has_fp32_engine():
            from repro_torch.models.cnn import conv_graph_steps
            steps = conv_graph_steps(self.prefill_cnn)
            groups = chunk_by_macs(jobsets, self.prefill_chunk_macs)
            conv = _ConvProgress(
                job.wave,
                [([steps[i] for i in g], [jobsets[i] for i in g])
                 for g in groups],
                frames, None, job.n_frames, hint, total=len(groups),
                qos=qos, rids=job.rids, tenant_names=tenant_names)
            self._submit_conv_chunk(conv)
            if self.prefill_chunk_macs is None:
                # legacy: ONE graph for the whole wave, reaped (and
                # cancelled on timeout) through the in-flight window
                self._push_inflight(_Inflight(
                    "prefill", [], graph=conv.fut, rids=job.rids,
                    tenant_names=tenant_names))
                return None
            return conv
        futs = self.runtime.submit_many(jobsets, affinity=hint, qos=qos)
        self._push_inflight(_Inflight("prefill", futs, rids=job.rids,
                                      tenant_names=tenant_names))
        return None

    def _submit_conv_chunk(self, conv: _ConvProgress) -> None:
        """Build and submit the next chunk's dataflow graph (gather and
        GEMM nodes per conv layer, gathers gated on the previous layer's
        GEMM so they overlap its panel execution)."""
        from repro_torch.models.cnn import conv_wave_graph
        steps, jss = conv.chunks.pop(0)
        nodes, edges = conv_wave_graph(
            self.prefill_cnn, self._cnn_params, conv.x, steps, jss,
            conv.n_frames, in_shape=conv.in_shape, affinity=conv.hint,
            im2col_fn=self._im2col, qos=conv.qos)
        name = (f"prefill/w{conv.wave}" if conv.total == 1
                else f"prefill/w{conv.wave}/c{conv.idx}")
        conv.fut = self.runtime.submit_graph(nodes, edges,
                                             affinity=conv.hint, name=name,
                                             qos=conv.qos)
        # the next chunk's first gather reshapes this chunk's flat output
        oh, ow, cout = steps[-1][3]
        conv.in_shape = (conv.n_frames, oh, ow, cout)
        conv.idx += 1
        if self.prefill_chunk_macs is not None:
            self.stats.prefill_chunks += 1

    def _advance_conv(self, conv: Optional[_ConvProgress]) -> bool:
        """Non-blocking chunk-chain progression: harvest a finished chunk
        graph (book accounting, take the carry) and submit the next."""
        if conv is None or conv.done:
            return False
        if conv.fut is not None:
            if not conv.fut.done():
                return False
            vals = conv.fut.result(0)
            self._book_runtime("prefill", conv.fut.accounting, conv.fut)
            conv.x = vals[-1]
            conv.fut = None
        if conv.chunks:
            self._submit_conv_chunk(conv)
        return True

    def _harvest_conv_blocking(self, conv: _ConvProgress) -> None:
        """Drain-path chunk harvest: block under ``submit_timeout``."""
        if conv.fut is not None:
            vals = self._graph_result(conv.fut, conv.rids,
                                      conv.tenant_names)
            self._book_runtime("prefill", conv.fut.accounting, conv.fut)
            conv.x = vals[-1]
            conv.fut = None
        if conv.chunks:
            self._submit_conv_chunk(conv)

    def _do_prefill_wave(self, wave: list) -> None:
        lens = [int(toks.shape[0]) for _, _, toks in wave]
        slots = [slot for _, slot, _ in wave]
        self.stats.prefill_waves += 1
        # stage the wave in ONE host->device copy: its prompt tokens (the
        # frames' ids), the batched replay's per-step tokens and
        # positions, and the admitted slots
        span = max(lens)
        n_tok = sum(lens)
        tok_np = np.zeros((span, self.slots, 1), np.int32)
        pos_np = np.full((span, self.slots), -1, np.int32)
        prompt = [np.asarray(toks, np.int32) for _, _, toks in wave]
        for (req, slot, _), toks, ln in zip(wave, prompt, lens):
            tok_np[:ln, slot, 0] = toks[:ln]
            pos_np[:ln, slot] = np.arange(ln)
        staged = torch.from_numpy(np.concatenate(
            [*prompt, tok_np.ravel(), pos_np.ravel(),
             np.asarray(slots, np.int32)])).to(self.device)
        grid = span * self.slots
        ids = staged[:n_tok]
        tok = staged[n_tok:n_tok + grid].view(span, self.slots, 1)
        pos = staged[n_tok + grid:n_tok + 2 * grid].view(span, self.slots)
        sl = staged[n_tok + 2 * grid:]

        # conv front-end FIRST: workers crunch the wave's first conv layer
        # while the host replays the LM prompt below (ARM-side /
        # accelerator-side overlap, §4.3)
        job = PrefillJob(self.stats.prefill_waves,
                         tuple(r.rid for r, _, _ in wave), tuple(slots),
                         n_frames=n_tok, cnn=self.prefill_cnn)
        frames = self._wave_frames(ids)
        conv = self._submit_prefill(
            job, frames, qos=self._prefill_qos(wave),
            tenant_names=tuple(r.tenant for r, _, _ in wave
                               if r.tenant))

        # slot reuse: zero the admitted slots' cache rows in place (every
        # cache tensor — K/V and SSM states alike — carries batch at axis
        # 1).  Attention masks stale K/V anyway; recurrent SSM state NEEDS
        # the reset or a reused slot would continue the previous recurrence.
        sl = sl.long()
        with torch.inference_mode():
            for a in _leaves(self.cache):
                a.index_fill_(1, sl, 0)

        # batched LM replay: ONE decode call per token index covers the
        # WHOLE wave (each admitted slot at its own position; slots not
        # being admitted — live decoders included — stay masked -1, so
        # their K/V and SSM state are never written).
        prog = _PrefillProgress(wave, lens, span, tok, pos, conv)
        if self.prefill_chunk_macs is None:
            self._replay_span(prog, 0, span)
            self._finalize_replay(prog)
            return
        # chunked: reserve the slots and advance one quantum now; decode
        # runs in the SAME engine step (the disjoint-slot masking above
        # makes the interleave bitwise-invisible to live decoders)
        self._prefilling.update(slots)
        self._progress = prog
        self._advance_prefill(prog)

    def _replay_quantum(self, n_wave: int) -> int:
        """Token indices one replay chunk may cover: the MAC budget over
        the wave's per-token LM cost (~n_layers · 4·d_model² per slot)."""
        per_tok = max(1, n_wave * self.cfg.n_layers
                      * 4 * self.cfg.d_model * self.cfg.d_model)
        return max(1, int(self.prefill_chunk_macs) // per_tok)

    def _replay_span(self, prog: _PrefillProgress, i0: int, i1: int) -> None:
        for i in range(i0, i1):
            logits, self.cache = self._decode(self.params, self.cache,
                                              prog.tok[i], prog.pos[i])
            for (req, slot, toks), ln in zip(prog.wave, prog.lens):
                if i == ln - 1:    # the prompt's last-token logits
                    prog.last_row[slot] = logits[slot, -1]

    def _finalize_replay(self, prog: _PrefillProgress) -> None:
        firsts = torch.argmax(
            torch.stack([prog.last_row[slot] for _, slot, _ in prog.wave]),
            dim=-1).cpu().numpy()
        replayed = False
        if self._journal is not None:
            emits = [[int(req.rid), int(slot), int(firsts[j])]
                     for j, (req, slot, _) in enumerate(prog.wave)]
            replayed = self._journal_emit("first", emits)
        for j, ((req, slot, toks), ln) in enumerate(zip(prog.wave,
                                                        prog.lens)):
            req.out.append(int(firsts[j]))
            self.slot_req[slot] = req
            self.slot_pos[slot] = ln
            if not replayed:
                self.stats.prefills += 1
                if self._qos_enabled and req.tenant in self.tenants:
                    self._tstats(req.tenant).prefills += 1
            self._prefilling.discard(slot)
        prog.finalized = True

    def _advance_prefill(self, prog: _PrefillProgress) -> bool:
        """One bounded chunk of the in-flight admission: harvest/submit a
        conv chunk if one completed, replay one LM token quantum.  Clears
        ``self._progress`` once replay AND conv chain are done."""
        worked = self._advance_conv(prog.conv)
        if prog.tok_i < prog.span:
            i1 = min(prog.span, prog.tok_i + self._replay_quantum(
                len(prog.wave)))
            self._replay_span(prog, prog.tok_i, i1)
            prog.tok_i = i1
            self.stats.prefill_chunks += 1
            worked = True
            if prog.tok_i >= prog.span:
                self._finalize_replay(prog)
        if prog.finalized and (prog.conv is None or prog.conv.done):
            self._progress = None
        return worked

    # --------------------------------------------------------------- decode
    def _build_decode_weight(self, cfg, params,
                             proxy: Optional[torch.Tensor]) -> torch.Tensor:
        """The coalesced decode GEMM's weight.  When the params expose the
        stacked per-layer FFN up-projection (``blocks.mlp.wi`` of shape
        (n_layers, d_model, 2·d_ff) — dense/vlm families), stack it along
        n into ``(d_model, n_layers·2·d_ff)`` so the decode GEMM computes
        every layer's REAL wi on the live embeddings.  Families without a
        dense FFN stack (moe experts, ssm/hybrid mamba blocks) fall back
        to the proxy ``(d_model, 4·d_model)`` weight: ``proxy`` when
        given, else seeded draws."""
        wi = None
        if isinstance(params, dict):
            blocks = params.get("blocks")
            if isinstance(blocks, dict):
                mlp = blocks.get("mlp")
                if isinstance(mlp, dict):
                    wi = mlp.get("wi")
        if (wi is not None and wi.dim() == 3
                and wi.shape[0] == cfg.n_layers
                and wi.shape[1] == cfg.d_model):
            self._decode_ffn_cols = int(wi.shape[2])
            return wi.permute(1, 0, 2).reshape(
                cfg.d_model,
                cfg.n_layers * self._decode_ffn_cols).to(torch.float32)
        self._decode_ffn_cols = None
        shape = (cfg.d_model, 4 * cfg.d_model)
        if proxy is not None:
            if tuple(proxy.shape) != shape:
                raise ValueError(f"decode_weight is {tuple(proxy.shape)}, "
                                 f"the proxy decode GEMM needs {shape}")
            return proxy.to(device=self.device, dtype=torch.float32)
        return (torch.randn(shape, generator=self._generator(0xD0),
                            device=self.device) * 0.05).to(torch.float32)

    def _slot_positions(self) -> np.ndarray:
        """(slots,) int32 of per-slot cache positions; -1 for empty slots."""
        return np.array(
            [self.slot_pos[i] if r is not None else -1
             for i, r in enumerate(self.slot_req)], np.int32)

    def _live_embeddings(self, live_toks: torch.Tensor
                         ) -> Optional[torch.Tensor]:
        """The step's LIVE-slot token embeddings — the activation panel of
        the decode GEMMs.  Empty slots are excluded: their padding
        token-0 embeddings are not traffic, and a large embed[0] row would
        inflate the max|a| EMA and waste int8 resolution on an artifact."""
        embed = (self.params.get("embed")
                 if isinstance(self.params, dict) else None)
        if embed is None or live_toks.shape[0] == 0:
            return None
        return embed[live_toks].to(torch.float32)

    def _submit_decode(self, job: DecodeJob,
                       acts: Optional[torch.Tensor]) -> None:
        js = job.jobset()
        hint_eng = self._affinity_hint(js, "decode")
        hint = hint_eng.name if hint_eng is not None else None
        qos = self._decode_qos(job.slots)
        rids = tuple(self.slot_req[s].rid for s in job.slots
                     if self.slot_req[s] is not None)
        tnames = tuple(self.slot_req[s].tenant for s in job.slots
                       if self.slot_req[s] is not None
                       and self.slot_req[s].tenant)
        if acts is None:
            # no embedding table: accounting-only coalesced submission
            fut = self.runtime.submit(js, affinity=hint, qos=qos)
            self._push_inflight(_Inflight("decode", [fut], rids=rids,
                                          tenant_names=tnames))
            return
        d, nl = self.cfg.d_model, self.cfg.n_layers
        w = self._decode_w
        n_cols = int(w.shape[1])
        wide = self._decode_ffn_cols is not None
        deg = self._degraded_rows(job.slots)
        degraded_applied = False
        cal = self._calibration_engine()
        if cal is None and hasattr(hint_eng, "observe_amax"):
            cal = hint_eng
        # device-side max|a| launched NOW, read at reap — skipped entirely
        # when nothing will consume it (fp32-only pool)
        amax = acts.abs().amax() if cal is not None else None
        groups = None
        if self.decode_mode == "batched":
            # ONE coalesced submission: real-FFN mode stacks every
            # layer's wi along n (rows = live slots); the proxy stacks
            # the per-layer GEMM along m — either way, one row-panel
            # split amortizes dispatch
            if wide and deg and len(deg) < len(job.slots):
                # shed ladder engaged on a mixed wave: split the row
                # panel so sheddable tenants' rows run through the
                # int8-only degraded class while the rest keep the full
                # decode class (stitched back by row index at reap)
                norm = tuple(j for j in range(len(job.slots))
                             if j not in set(deg))
                groups = (norm, tuple(deg))
                degraded_applied = True
                futs = []
                for g, jc in zip(groups, ("decode", "decode_degraded")):
                    js_g = JobSet.for_gemm(
                        job.step, len(g), n_cols, d, _SERVE_TILE,
                        name=f"decode/s{job.step}/{jc}")
                    h_eng = self._affinity_hint(js_g, jc)
                    futs.append(self.runtime.submit_gemm(
                        acts[list(g)], w, jobset=js_g,
                        tile=(_SERVE_TILE,) * 3, job_class=jc,
                        affinity=h_eng.name if h_eng is not None else None,
                        qos=self._decode_qos([job.slots[j] for j in g]),
                        observe_acts=False))
            else:
                jc = "decode"
                if wide and deg and len(deg) == len(job.slots):
                    jc = "decode_degraded"
                    degraded_applied = True
                a = acts if wide else acts.repeat(nl, 1)
                futs = [self.runtime.submit_gemm(
                    a, w, jobset=js, tile=(_SERVE_TILE,) * 3,
                    job_class=jc, affinity=hint, qos=qos,
                    observe_acts=False)]
        else:
            # the sequential per-slot baseline (one submission per slot)
            futs = []
            degset = set(deg)
            for j, slot in enumerate(job.slots):
                m_j = 1 if wide else nl
                jc = "decode_degraded" if j in degset else "decode"
                degraded_applied = degraded_applied or jc != "decode"
                js_j = JobSet.for_gemm(
                    job.step, m_j, n_cols, d, _SERVE_TILE,
                    name=f"decode/s{job.step}/slot{slot}")
                a_j = (acts[j:j + 1] if wide
                       else acts[j:j + 1].repeat(nl, 1))
                futs.append(self.runtime.submit_gemm(
                    a_j, w, jobset=js_j, tile=(_SERVE_TILE,) * 3,
                    job_class=jc, affinity=hint, qos=qos,
                    observe_acts=False))
        if degraded_applied:
            self.stats.shed_degraded_steps += 1
            for j in deg:
                req = self.slot_req[job.slots[j]]
                if req is not None and req.tenant in self.tenants:
                    self._tstats(req.tenant).degraded_steps += 1
        self._push_inflight(_Inflight(
            "decode", futs, cal_engine=cal, amax=amax, cal_key=(d, n_cols),
            layout=(len(job.slots), nl), wide=wide, groups=groups,
            rids=rids, tenant_names=tnames))

    def _do_decode(self) -> None:
        live = tuple(i for i, r in enumerate(self.slot_req) if r is not None)
        # ONE host->device copy for the step: every slot's last token, the
        # per-slot positions (-1 = empty) and the live slots' token ids
        toks_np = np.zeros(self.slots, np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.out:
                toks_np[i] = r.out[-1]
        staged = torch.from_numpy(np.concatenate(
            [toks_np, self._slot_positions(),
             toks_np[list(live)]])).to(self.device)
        toks = staged[:self.slots].view(self.slots, 1)
        pos = staged[self.slots:2 * self.slots]
        job = DecodeJob(self.stats.decode_steps, live, self.cfg.d_model,
                        self.cfg.n_layers, self._decode_ffn_cols)
        acts = self._live_embeddings(staged[2 * self.slots:])
        if self.runtime is not None:
            self._submit_decode(job, acts)
        else:
            eng = self._account_dispatch("decode", job.jobset())
            if acts is not None and hasattr(eng, "observe_activations"):
                eng.observe_activations(acts, self.cfg.d_model,
                                        int(self._decode_w.shape[1]))
        # per-slot positions: each live slot reads/writes at ITS OWN index
        # (a shared max(pos) would smear late-arriving requests' tokens
        # into earlier requests' cache rows); empty slots are masked (-1)
        logits, self.cache = self._decode(self.params, self.cache, toks, pos)
        self.stats.decode_steps += 1
        # ONE device argmax + ONE host sync for the whole batch
        nxt_all = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        replayed = False
        if self._journal is not None:
            # WAL the step's emissions BEFORE appending to the visible
            # streams (during replay: verify bitwise instead)
            emits = [[int(r.rid), i, int(nxt_all[i])]
                     for i, r in enumerate(self.slot_req) if r is not None]
            replayed = self._journal_emit("tok", emits)
        now = time.monotonic()
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            nxt = int(nxt_all[i])
            r.out.append(nxt)
            self.slot_pos[i] += 1
            if replayed:
                self.stats.replayed_tokens += 1
            else:
                self.stats.tokens_out += 1
                if self._qos_enabled and r.tenant in self.tenants:
                    self._tstats(r.tenant).tokens_out += 1
            done = (len(r.out) >= r.max_new_tokens
                    or self.slot_pos[i] >= self.max_len - 1)
            if done:
                # stamped on EVERY server so attainment is computable
                # post-hoc even without tenancy
                r.done_at = now
                if (not replayed and self._qos_enabled
                        and r.tenant in self.tenants
                        and math.isfinite(r.deadline_at)):
                    ts = self._tstats(r.tenant)
                    hit = now <= r.deadline_at
                    if hit:
                        ts.deadline_hits += 1
                    else:
                        ts.deadline_misses += 1
                    tr = self._tracer
                    if tr is not None:
                        tr.emit("deadline_hit" if hit else "deadline_miss",
                                "serving", rid=r.rid, tenant=r.tenant,
                                margin_s=r.deadline_at - now)
                self.slot_req[i] = None   # free the slot (continuous batching)
