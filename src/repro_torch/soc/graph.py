"""repro_torch.soc.graph — dataflow-graph submissions over the live runtime.

Synergy's throughput comes from keeping every engine busy at once, but a
chain of dependent GEMMs submitted one-at-a-time serializes at every reap:
the pool idles exactly where the paper's pipeline overlaps (NEURAghe's
producer/consumer overlap between convolution stages is the same
observation).  This module adds the missing structure: a *graph* of nodes
with explicit dependency edges, where a successor's panels enter the
worker deques the moment its predecessors' tail panels land.

Node kinds
----------
* **JobSet node** — an accounting-only submission (the serving proxies'
  currency).  Its tile jobs are scheduled, stolen and booked exactly as a
  :meth:`~repro_torch.soc.runtime.SynergyRuntime.submit` would, but gated on the
  node's predecessors.
* **run node** (:class:`GraphNode` with ``run=``) — a host-side callable
  ``run(runtime, *pred_values)`` executed on the runtime's host executor
  (never an engine worker, so a CPU stage cannot stall an accelerator
  queue).  It may return a plain value (e.g. an im2col gather) or a
  :class:`~repro_torch.soc.runtime.RuntimeFuture` (e.g. a nested
  ``submit_gemm``), which the graph *adopts*: the node completes when the
  submission's tail panel completes.

Scheduling mechanics: per-node remaining-dependency counters are
decremented at (tail) panel completion **under the manager lock**, and
newly ready nodes are LPT-seeded into the existing per-engine deques — so
work stealing and hotplug rebalances apply to graph work unchanged, and
the virtual-time :class:`~repro_torch.soc.simrt.SimRuntime` replays the
same decisions via ``run_graph``.

On a card, a run node's tensors stay on the runtime's device: "host"
names the thread that launches the work, not where it runs.  Host
executor threads launch on the device's default stream, and an adopted
``submit_gemm`` enqueues its merge on that stream before its future
completes, so a successor reads every predecessor value in stream order.

Failure / cancellation: a failed node cancels every not-yet-started
descendant, and :meth:`GraphFuture.cancel` additionally DRAINS the
queued-but-unstarted panels of running graph submissions from the worker
deques (in-flight panels finish).  No orphan panels outlive a dead graph.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

from .qos_policy import NEUTRAL_TAG

__all__ = ["GraphNode", "GraphFuture", "GraphCancelled", "validate_dag"]


class GraphCancelled(RuntimeError):
    """The graph (or this node's upstream) was cancelled before it ran."""


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One dataflow-graph node: exactly one of ``jobset`` / ``run``.

    ``jobset``: an accounting-only JobSet scheduled at ``granularity``
    ("job" or "row", like :meth:`SynergyRuntime.submit`).
    ``run(runtime, *pred_values)``: host-side callable; a returned
    :class:`RuntimeFuture` is adopted as the node's completion."""

    name: str = ""
    jobset: Any = None
    run: Optional[Callable] = None
    granularity: Optional[str] = None

    def __post_init__(self):
        if (self.jobset is None) == (self.run is None):
            raise ValueError(
                f"GraphNode {self.name!r}: exactly one of jobset/run")


def validate_dag(n: int, edges) -> tuple[list[list[int]], list[list[int]]]:
    """Check ``edges`` over ``n`` nodes form a DAG; returns
    ``(successors, predecessors)`` adjacency (edge-order preserved, which
    fixes the argument order of a run node's ``*pred_values``)."""
    succs: list[list[int]] = [[] for _ in range(n)]
    preds: list[list[int]] = [[] for _ in range(n)]
    for e in edges:
        u, v = e
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(f"edge {e!r} out of range for {n} nodes")
        if u == v:
            raise ValueError(f"self-edge on node {u}")
        succs[u].append(v)
        preds[v].append(u)
    # Kahn: every node must be reachable through a topological order
    indeg = [len(p) for p in preds]
    ready = [i for i in range(n) if indeg[i] == 0]
    seen = 0
    while ready:
        u = ready.pop()
        seen += 1
        for v in succs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if seen != n:
        raise ValueError("graph has a dependency cycle")
    return succs, preds


class GraphFuture:
    """Completion handle for one graph run.

    ``result()`` returns the list of per-node values (None for JobSet
    nodes); ``accounting`` merges every node submission's per-engine
    accounting; ``finish_order`` records node indices in completion order
    (every predecessor strictly before its successors — the reap-order
    audit trail); ``cancel()`` stops everything that has not started."""

    def __init__(self, run: "_GraphRun", name: str):
        self._run = run
        self.name = name
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        #: node indices in completion order
        self.finish_order: list[int] = []

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> list:
        if not self._event.wait(timeout):
            raise TimeoutError(f"graph {self.name!r} not done in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def cancel(self, why: str = "graph cancelled") -> int:
        """Cancel every node that has not started and drain running graph
        submissions' queued panels from the worker deques (in-flight
        panels finish).  Returns the number of nodes cancelled."""
        return self._run.cancel(why)

    def node_future(self, i: int):
        """The RuntimeFuture backing node ``i`` (None until it launches,
        and always None for pure host nodes)."""
        with self._run.rt._lock:
            return self._run.node_futs[i]

    def node_states(self) -> list[str]:
        with self._run.rt._lock:
            return list(self._run.state)

    @property
    def accounting(self) -> dict:
        """Merged per-engine accounting over every node submission so far
        (same schema as ``RuntimeFuture.accounting``)."""
        with self._run.rt._lock:
            futs = [f for f in self._run.node_futs if f is not None]
        merged: dict[str, dict] = {}
        for f in futs:
            for name, a in f.accounting.items():
                m = merged.setdefault(name, {"jobs": 0, "est_s": 0.0,
                                             "bytes": 0, "steals": 0})
                for key in m:
                    m[key] += a.get(key, 0)
        return merged

    @property
    def retries(self) -> int:
        """Recovery work this graph consumed: node-level relaunches plus
        every node submission's panel-level retries."""
        with self._run.rt._lock:
            futs = [f for f in self._run.node_futs if f is not None]
            n = sum(self._run.node_attempts)
        return n + sum(getattr(f, "retries", 0) for f in futs)

    # internal -------------------------------------------------------------
    def _finish(self, value: Any, error: Optional[BaseException]) -> None:
        self._value, self._error = value, error
        self._event.set()


class _GraphRun:
    """Execution state of one graph over a SynergyRuntime.

    All mutation happens under the runtime's manager lock (``rt._cond``):
    node launches, dependency decrements, cancellation.  Completion hooks
    arrive from worker threads (tail-panel completion) and from host
    executor threads; both funnel through :meth:`_node_done`."""

    def __init__(self, rt, nodes, edges, *, affinity: Optional[str],
                 granularity: str, name: str, qos=None,
                 node_retries: int = 0):
        norm: list[GraphNode] = []
        for node in nodes:
            if isinstance(node, GraphNode):
                norm.append(node)
            else:                      # bare JobSet (the public API's core)
                norm.append(GraphNode(name=getattr(node, "name", ""),
                                      jobset=node))
        if not norm:
            raise ValueError("submit_graph needs at least one node")
        self.rt = rt
        self.nodes = norm
        self.succs, self.preds = validate_dag(len(norm), edges)
        self.remaining = [len(p) for p in self.preds]
        self.affinity = affinity
        self.granularity = granularity
        #: QosTag every node submission of this graph carries (None =
        #: neutral) — chunked prefill graphs inherit their wave's class,
        #: which is what lets decode preempt them at chunk boundaries
        self.qos = qos
        n = len(norm)
        self.values: list[Any] = [None] * n
        self.state = ["waiting"] * n   # running | done | failed | cancelled
        self.node_futs: list = [None] * n
        #: whole-node retry budget: a failed node relaunches (fresh
        #: submission) up to ``node_retries`` times BEFORE its descendants
        #: are cancelled — the graph-level second line of defense behind
        #: the runtime's panel-level RetryPolicy
        self.max_node_retries = node_retries
        self.node_attempts = [0] * n
        self.n_left = n
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.future = GraphFuture(self, name)

    def _emit(self, kind: str, i: int, **tags) -> None:
        """Trace one node transition on the shared ``graph`` track (the
        runtime's tracer; one attribute check when tracing is off)."""
        tr = self.rt._tracer
        if tr is not None:
            tr.emit(kind, "graph", graph=self.future.name, node=i,
                    node_name=self.nodes[i].name, **tags)

    # ------------------------------------------------------------- control
    def start(self) -> None:
        rt = self.rt
        with rt._cond:
            if not rt._started:
                raise RuntimeError(f"runtime {rt.name!r} is not started")
            rt._graphs.add(self)
            for i, r in enumerate(self.remaining):
                if r == 0:
                    self._launch_locked(i)

    def cancel(self, why: str = "graph cancelled") -> int:
        rt = self.rt
        with rt._cond:
            if self.future.done():
                return 0
            self.cancelled = True
            n = 0
            for i, st in enumerate(self.state):
                if st == "waiting":
                    self.state[i] = "cancelled"
                    self.n_left -= 1
                    n += 1
                    self._emit("graph_node_cancelled", i, why=why)
            # drain this graph's queued-but-unstarted panels; their
            # submissions then complete with the cancellation error, which
            # funnels back through _node_done for the affected nodes
            live = {id(f) for i, f in enumerate(self.node_futs)
                    if f is not None and self.state[i] == "running"}
            rt._drain_jobs_locked(lambda job: id(job.sub.future) in live,
                                  GraphCancelled(why))
            if self.n_left == 0:
                self._finish_locked()
            return n

    # ---------------------------------------------------------- launching
    def _launch_locked(self, i: int) -> None:
        if self.cancelled or self.rt._stopping:
            self.state[i] = "cancelled"
            self.n_left -= 1
            self._emit("graph_node_cancelled", i, why="graph cancelled")
            if self.n_left == 0:
                self._finish_locked()
            return
        self.state[i] = "running"
        self._emit("graph_node_ready", i)
        node = self.nodes[i]
        if node.jobset is not None:
            self._submit_jobset_locked(i, node)
        else:
            self.rt._host_submit(self._run_host, i)

    def _submit_jobset_locked(self, i: int, node: GraphNode) -> None:
        from .runtime import RuntimeFuture, _RuntimeJob, _Submission
        rt = self.rt
        units = rt._accounting_units(node.jobset,
                                     node.granularity or self.granularity)
        if not units:
            fut = RuntimeFuture(node.jobset)
            fut._finish(None, None)
            self.node_futs[i] = fut
            self._node_done_locked(i, None, None)
            return

        def on_done(fut, i=i):
            rt._on_submission_done(fut)
            self._node_done(i, fut._value, fut._error)

        sub = _Submission(node.jobset, len(units), None, on_done=on_done)
        tag = self.qos or NEUTRAL_TAG
        jobs = [_RuntimeJob(sub, u, fn, n_jobs, macs, nbytes,
                            priority=tag.priority,
                            deadline_at=tag.deadline_at)
                for u, (fn, n_jobs, macs, nbytes) in enumerate(units)]
        self.node_futs[i] = sub.future
        rt._submissions += 1
        rt._inflight += 1
        rt._seed_locked(jobs, self.affinity)
        rt._cond.notify_all()

    def _run_host(self, i: int) -> None:
        """Host-executor body of a run node."""
        from .runtime import RuntimeFuture
        node = self.nodes[i]
        with self.rt._cond:
            if self.cancelled or self.state[i] != "running":
                self._node_done_locked(
                    i, None, GraphCancelled(f"node {node.name!r} cancelled"))
                return
            pvals = [self.values[p] for p in self.preds[i]]
        try:
            out = node.run(self.rt, *pvals)
        except BaseException as e:
            self._node_done(i, None, e)
            return
        if isinstance(out, RuntimeFuture):
            with self.rt._cond:
                self.node_futs[i] = out
            out.add_done_callback(
                lambda f, i=i: self._node_done(i, f._value, f._error))
        else:
            self._node_done(i, out, None)

    # ---------------------------------------------------------- completion
    def _node_done(self, i: int, value: Any,
                   error: Optional[BaseException]) -> None:
        with self.rt._cond:
            self._node_done_locked(i, value, error)

    def _node_done_locked(self, i: int, value: Any,
                          error: Optional[BaseException]) -> None:
        if self.state[i] not in ("waiting", "running"):
            return
        if (error is not None and isinstance(error, Exception)
                and not isinstance(error, GraphCancelled)
                and not self.cancelled and not self.rt._stopping
                and self.node_attempts[i] < self.max_node_retries):
            # node retry BEFORE descendant-cancel: relaunch the whole node
            # as a fresh submission; descendants only die once the budget
            # is spent.  The node never entered finish_order / n_left, so
            # the graph's completion accounting is untouched.
            self.node_attempts[i] += 1
            self._emit("graph_node_retry", i,
                       attempt=self.node_attempts[i],
                       err=type(error).__name__)
            self.state[i] = "waiting"
            self.node_futs[i] = None
            self._launch_locked(i)
            return
        self.future.finish_order.append(i)
        self.n_left -= 1
        if error is not None:
            self.state[i] = "failed"
            self._emit("graph_node_done", i, ok=False,
                       err=type(error).__name__)
            if self.error is None:
                self.error = error
            self._cancel_descendants_locked(i)
        else:
            self.values[i] = value
            self.state[i] = "done"
            self._emit("graph_node_done", i, ok=True)
            if not self.cancelled:
                for s in self.succs[i]:
                    self.remaining[s] -= 1
                    if self.remaining[s] == 0 and self.state[s] == "waiting":
                        self._launch_locked(s)
        if self.n_left == 0:
            self._finish_locked()

    def _cancel_descendants_locked(self, i: int) -> None:
        """A failed node's descendants can never become ready — finish
        them as cancelled so the graph terminates (the invariant:
        downstream jobsets never start)."""
        stack = list(self.succs[i])
        while stack:
            s = stack.pop()
            if self.state[s] == "waiting":
                self.state[s] = "cancelled"
                self.n_left -= 1
                self._emit("graph_node_cancelled", s,
                           why=f"upstream node {i} failed")
                stack.extend(self.succs[s])

    def _finish_locked(self) -> None:
        self.rt._graphs.discard(self)
        if self.error is not None:
            self.future._finish(None, self.error)
        elif self.cancelled or "cancelled" in self.state:
            self.future._finish(None, GraphCancelled(
                f"graph {self.future.name!r} cancelled "
                f"({self.state.count('cancelled')} nodes never started)"))
        else:
            self.future._finish(list(self.values), None)
