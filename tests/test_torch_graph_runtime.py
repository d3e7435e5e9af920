"""The port's dataflow-graph runtime (``soc/graph.py``,
``SynergyRuntime.submit_graph``) and ``models/cnn.py``'s wave graphs
against repro's, on the CPU (``device="cpu"``): ``validate_dag``'s errors,
accounting-only DAGs, value flow through adopted ``submit_gemm`` futures,
failure and cancellation (queued panels drained, descendants cancelled,
shutdown), random DAGs executed exactly once in edge order, and the conv
front-end of CIFAR_Alex+ as a wave graph.

Tolerances: 1e-5 for GEMM values (fp32, summed in another order than
repro's).  repro's ``test_graph_parallel_branches_share_the_pool`` holds
a split GEMM bitwise to one ``jnp.dot`` and fails in repro, so it is no
oracle: here the branches are held within 1e-5 of repro's values.  Every
wait has a timeout; the cancel and shutdown tests order their events on
``threading.Event``s, not on sleeps."""

import importlib.util
import random
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnns import PAPER_CNNS as JAX_CNNS
from repro.core.job import JobSet as JaxJobSet
from repro.models import cnn as jax_cnn
from repro.soc import GraphNode as JaxGraphNode
from repro.soc import SynergyRuntime as JaxSynergyRuntime
from repro.soc.graph import validate_dag as jax_validate_dag
from repro_torch.configs import PAPER_CNNS
from repro_torch.core.job import JobSet
from repro_torch.engines import CAP_GEMM, CostModel, Engine
from repro_torch.kernels.tiled_mm import tiled_mm_ref
from repro_torch.models import cnn
from repro_torch.soc import (GraphCancelled, GraphFuture, GraphNode,
                             SynergyRuntime)
from repro_torch.soc.graph import validate_dag

ROOT = Path(__file__).resolve().parents[1]
POOL = ["F-PE", "S-PE", "cuda-tiled", "neon-vpu"]
TIMEOUT = 30


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _DelayEngine(Engine):
    """Deterministic-output engine with seeded random per-panel delays:
    randomized steal timing without randomized results."""

    def __init__(self, name, macs_per_s=1e9, seed=0, max_delay_s=0.003):
        super().__init__(name, {CAP_GEMM, "epilogue"},
                         cost=CostModel(macs_per_s=macs_per_s))
        self._rng = random.Random(seed)
        self._max_delay_s = max_delay_s

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        time.sleep(self._rng.random() * self._max_delay_s)
        return tiled_mm_ref(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)


class _GatedEngine(Engine):
    """Every panel waits for ``release``; ``started`` is set when the first
    one is in flight, so the rest of its submission is still queued."""

    def __init__(self, name="gated"):
        super().__init__(name, {CAP_GEMM, "epilogue"},
                         cost=CostModel(macs_per_s=1e9))
        self.started = threading.Event()
        self.release = threading.Event()
        self.executed = 0

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        self.started.set()
        if not self.release.wait(TIMEOUT):
            raise TimeoutError("gate never opened")
        self.executed += 1
        return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


# ----------------------------------------------------------- validate_dag

@pytest.mark.parametrize("n,edges", [
    (3, [(0, 1), (1, 2), (2, 0)]), (2, [(0, 0)]), (2, [(0, 5)]),
    (2, [(-1, 1)]), (4, [(0, 1), (1, 2), (2, 3), (3, 1)])],
    ids=["cycle", "self-edge", "out-of-range", "negative", "back-edge"])
def test_validate_dag_raises_as_repro_does(n, edges):
    with pytest.raises(ValueError) as ei:
        validate_dag(n, edges)
    with pytest.raises(ValueError) as jei:
        jax_validate_dag(n, edges)
    assert str(ei.value) == str(jei.value)


@pytest.mark.parametrize("n,edges", [
    (3, [(0, 2), (1, 2)]), (4, [(0, 1), (0, 2), (1, 3), (2, 3)]),
    (1, []), (5, [(3, 4), (0, 4), (1, 3), (2, 0)])])
def test_validate_dag_adjacency_matches_repro(n, edges):
    assert validate_dag(n, edges) == jax_validate_dag(n, edges)


# ----------------------------------------------- accounting-only DAG nodes

def test_graph_accounting_diamond_orders_and_books_all_jobs():
    """Bare JobSets as nodes: every tile job is scheduled and booked, as in
    repro, and the completion order respects every dependency edge."""
    jss = [JobSet.for_gemm(i, 96, 64, 32, 32, name=f"n{i}")
           for i in range(4)]
    edges = [(0, 1), (0, 2), (1, 3), (2, 3)]
    with SynergyRuntime(["F-PE", "S-PE"], name="diamond",
                        device="cpu") as rt:
        gf = rt.submit_graph(jss, edges, name="diamond")
        assert isinstance(gf, GraphFuture)
        vals = gf.result(TIMEOUT)
        total_jobs = rt.stats()["total_jobs"]
    with JaxSynergyRuntime(["F-PE", "S-PE"], name="diamond") as jrt:
        jgf = jrt.submit_graph([JaxJobSet.for_gemm(i, 96, 64, 32, 32,
                                                   name=f"n{i}")
                                for i in range(4)], edges, name="diamond")
        jgf.result(TIMEOUT)
    assert vals == [None] * 4
    pos = {nid: i for i, nid in enumerate(gf.finish_order)}
    for u, v in edges:
        assert pos[u] < pos[v], (gf.finish_order, (u, v))
    assert gf.node_states() == jgf.node_states() == ["done"] * 4
    total = sum(a["jobs"] for a in gf.accounting.values())
    assert total == sum(js.num_jobs for js in jss) == total_jobs
    assert total == sum(a["jobs"] for a in jgf.accounting.values())


def test_graph_empty_jobset_node_cascades():
    """A zero-job node completes instantly and releases its successors."""
    empty = JobSet.for_gemm(0, 0, 32, 32, 32, name="empty")
    real = JobSet.for_gemm(1, 64, 32, 32, 32, name="real")
    with SynergyRuntime(["F-PE"], name="empty", device="cpu") as rt:
        gf = rt.submit_graph([empty, real], [(0, 1)])
        gf.result(TIMEOUT)
    assert gf.node_states() == ["done", "done"]
    assert gf.node_future(0).done()


# ------------------------------------------------- value flow (run nodes)

def test_graph_value_flow_adopted_gemm_matches_repro():
    """Host nodes flow values along edges; a run node returning a
    RuntimeFuture (nested submit_gemm) is ADOPTED, and the chained value
    matches repro's serial reference."""
    a, w1, w2 = _np(1, 48, 32), _np(2, 32, 32), _np(3, 32, 24)
    ta, tw1, tw2 = map(torch.from_numpy, (a, w1, w2))
    js1 = JobSet.for_gemm(0, 48, 32, 32, 16, name="g1")
    js2 = JobSet.for_gemm(1, 48, 24, 32, 16, name="g2")
    nodes = [
        GraphNode(name="scale", run=lambda rt: ta * 2.0),
        GraphNode(name="g1", run=lambda rt, x: rt.submit_gemm(
            x, tw1, jobset=js1, tile=(16, 16, 16))),
        GraphNode(name="relu", run=lambda rt, y: torch.relu(y)),
        GraphNode(name="g2", run=lambda rt, y: rt.submit_gemm(
            y, tw2, jobset=js2, tile=(16, 16, 16))),
    ]
    with SynergyRuntime(POOL, name="flow", device="cpu") as rt:
        gf = rt.submit_graph(nodes, [(0, 1), (1, 2), (2, 3)], name="flow")
        vals = gf.result(TIMEOUT)
    want = jnp.dot(jax.nn.relu(jnp.dot(jnp.asarray(a) * 2.0,
                                       jnp.asarray(w1))), jnp.asarray(w2))
    np.testing.assert_allclose(vals[3].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert gf.node_future(1) is not None      # adopted submission futures
    assert gf.node_future(0) is None          # pure host node: no future
    assert gf.finish_order == [0, 1, 2, 3]


def test_graph_parallel_branches_match_repro():
    """Two independent GEMM branches fan out over the pool and a join
    node sees both predecessor values in edge order; within 1e-5 of
    repro's graph on its own pool."""
    a, w = _np(4, 64, 32), _np(5, 32, 32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    jss = [JobSet.for_gemm(i, 64, 32, 32, 16, name=f"br{i}")
           for i in range(2)]
    nodes = [
        GraphNode(name="b0", run=lambda rt: rt.submit_gemm(
            ta, tw, jobset=jss[0], tile=(16, 16, 16))),
        GraphNode(name="b1", run=lambda rt: rt.submit_gemm(
            ta * 3.0, tw, jobset=jss[1], tile=(16, 16, 16))),
        GraphNode(name="join", run=lambda rt, y0, y1: y0 + y1),
    ]
    with SynergyRuntime(POOL, name="fan", device="cpu") as rt:
        gf = rt.submit_graph(nodes, [(0, 2), (1, 2)], name="fan")
        vals = gf.result(TIMEOUT)
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    jjss = [JaxJobSet.for_gemm(i, 64, 32, 32, 16, name=f"br{i}")
            for i in range(2)]
    jnodes = [
        JaxGraphNode(name="b0", run=lambda rt: rt.submit_gemm(
            ja, jw, jobset=jjss[0], tile=(16, 16, 16))),
        JaxGraphNode(name="b1", run=lambda rt: rt.submit_gemm(
            ja * 3.0, jw, jobset=jjss[1], tile=(16, 16, 16))),
        JaxGraphNode(name="join", run=lambda rt, y0, y1: y0 + y1),
    ]
    with JaxSynergyRuntime(["F-PE", "S-PE"], name="fan") as jrt:
        want = jrt.submit_graph(jnodes, [(0, 2), (1, 2)],
                                name="fan").result(TIMEOUT)
    for got, ref in zip(vals, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(vals[2], vals[0] + vals[1])


# ------------------------------------------------- failure / cancellation

def test_graph_failure_cancels_descendants_as_in_repro():
    def fail(rt, x):
        raise RuntimeError("boom")

    def graph(node_cls):
        return [node_cls(name="ok", run=lambda rt: 1),
                node_cls(name="bad", run=fail),
                node_cls(name="downstream", run=lambda rt, x: x)]

    with SynergyRuntime(["F-PE"], name="fail", device="cpu") as rt:
        gf = rt.submit_graph(graph(GraphNode), [(0, 1), (1, 2)])
        with pytest.raises(RuntimeError, match="boom"):
            gf.result(TIMEOUT)
    with JaxSynergyRuntime(["F-PE"], name="fail") as jrt:
        jgf = jrt.submit_graph(graph(JaxGraphNode), [(0, 1), (1, 2)])
        with pytest.raises(RuntimeError, match="boom"):
            jgf.result(TIMEOUT)
    assert gf.node_states() == jgf.node_states() == [
        "done", "failed", "cancelled"]


def _head_tail_graph(eng_rows=4):
    a, w = _np(6, eng_rows * 16, 32), _np(7, 32, 16)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    js0 = JobSet.for_gemm(0, ta.shape[0], 16, 32, 16, name="head")
    js1 = JobSet.for_gemm(1, ta.shape[0], 16, 16, 16, name="tail")
    nodes = [
        GraphNode(name="head", run=lambda rt: rt.submit_gemm(
            ta, tw, jobset=js0, tile=(16, 16, 16))),
        GraphNode(name="tail", run=lambda rt, y: rt.submit_gemm(
            y, tw[:16], jobset=js1, tile=(16, 16, 16))),
    ]
    return ta, tw, nodes


def test_graph_cancel_drains_queued_panels_and_downstream():
    """cancel() marks every not-yet-started node cancelled AND drains the
    running submission's queued panels: with one panel in flight and three
    queued, exactly one executes, and the runtime keeps serving."""
    eng = _GatedEngine()
    ta, tw, nodes = _head_tail_graph()
    with SynergyRuntime([eng], name="cancel", device="cpu") as rt:
        gf = rt.submit_graph(nodes, [(0, 1)], name="cancel")
        assert eng.started.wait(TIMEOUT)   # one panel in flight, 3 queued
        assert gf.cancel("test cancel") == 1
        eng.release.set()
        with pytest.raises(GraphCancelled, match="test cancel"):
            gf.result(TIMEOUT)
        assert eng.executed == 1
        assert gf.node_states() == ["failed", "cancelled"]
        assert gf.node_future(0).execution_counts == [1] * 4
        y = rt.submit_gemm(ta[:16], tw, jobset=JobSet.for_gemm(
            2, 16, 16, 32, 16, name="after"), tile=(16, 16, 16)).result(
                TIMEOUT)
    assert torch.equal(y, torch.matmul(ta[:16], tw))


def test_runtime_shutdown_cancels_active_graphs():
    """Shutdown cancels a graph before it joins the workers: the queued
    panels drain, the downstream node never starts, the graph ends in an
    error and the workers exit."""
    eng = _GatedEngine()
    _, _, nodes = _head_tail_graph()
    rt = SynergyRuntime([eng], name="shut", device="cpu")
    rt.start()
    gf = rt.submit_graph(nodes, [(0, 1)], name="shut")
    assert eng.started.wait(TIMEOUT)
    stopper = threading.Thread(target=rt.shutdown)
    stopper.start()
    deadline = time.monotonic() + TIMEOUT
    while gf.node_states()[1] != "cancelled":
        assert time.monotonic() < deadline, gf.node_states()
        time.sleep(1e-3)
    eng.release.set()
    stopper.join(TIMEOUT)
    assert not stopper.is_alive()
    with pytest.raises((GraphCancelled, RuntimeError)):
        gf.result(TIMEOUT)
    assert eng.executed == 1
    assert not rt._graphs and rt._host_pool is None


# ------------------------------------------ randomized DAG property sweep

def _random_dag_case(seed: int):
    rng = random.Random(seed)
    n = rng.randint(3, 6)
    edges = [(u, v) for u in range(n) for v in range(u + 1, n)
             if rng.random() < 0.45]
    kinds = [rng.choice(["gemm", "acct"]) for _ in range(n)]
    return n, edges, kinds


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_random_dag_exactly_once_ordered_and_bitwise(seed):
    """Random DAGs of GEMM run nodes and accounting nodes over a pool with
    randomized steal timing: every node runs exactly once, predecessors
    complete strictly before successors, and each GEMM node's value is
    bitwise the same GEMM submitted alone afterwards on the same runtime
    (every engine here computes a panel with the same plain matmul)."""
    n, edges, kinds = _random_dag_case(seed)
    _, preds = validate_dag(n, edges)
    d = 32
    base = [torch.from_numpy(_np(100 + i, 48, d)) for i in range(n)]
    w = torch.from_numpy(_np(7, d, d))
    ran: list[int] = []

    def make_node(i):
        if kinds[i] == "acct":
            return GraphNode(name=f"acct{i}",
                             jobset=JobSet.for_gemm(i, 96, 64, 32, 32,
                                                    name=f"acct{i}"))

        def run(rt, *pvals, _i=i):
            ran.append(_i)
            x = base[_i]
            for pv in pvals:
                if pv is not None:       # accounting preds carry no value
                    x = x + pv
            return rt.submit_gemm(x, w, jobset=JobSet.for_gemm(
                _i, 48, d, d, 16, name=f"gemm{_i}"), tile=(16, 16, 16))
        return GraphNode(name=f"gemm{i}", run=run)

    pool = [_DelayEngine("dly-a", seed=seed),
            _DelayEngine("dly-b", seed=seed + 9), "neon-vpu"]
    with SynergyRuntime(pool, name=f"rand{seed}", device="cpu") as rt:
        gf = rt.submit_graph([make_node(i) for i in range(n)], edges,
                             name=f"rand{seed}")
        vals = gf.result(TIMEOUT)
        ref: list = [None] * n
        for i in range(n):
            if kinds[i] == "acct":
                continue
            x = base[i]
            for p in preds[i]:
                if ref[p] is not None:
                    x = x + ref[p]
            ref[i] = rt.submit_gemm(x, w, jobset=JobSet.for_gemm(
                i, 48, d, d, 16, name=f"ref{i}"),
                tile=(16, 16, 16)).result(TIMEOUT)
    assert sorted(ran) == [i for i in range(n) if kinds[i] == "gemm"]
    assert sorted(gf.finish_order) == list(range(n))
    pos = {nid: i for i, nid in enumerate(gf.finish_order)}
    for u, v in edges:
        assert pos[u] < pos[v]
    assert gf.node_states() == ["done"] * n
    for i in range(n):
        if kinds[i] == "gemm":
            assert torch.equal(vals[i], ref[i]), i
        else:
            assert vals[i] is None
    acct = sum(JobSet.for_gemm(i, 96, 64, 32, 32).num_jobs
               for i in range(n) if kinds[i] == "acct")
    assert sum(a["jobs"] for a in gf.accounting.values()) == acct + sum(
        3 * 2 for i in range(n) if kinds[i] == "gemm")


# ----------------------------------------------- the CNN wave graphs

@pytest.mark.parametrize("name", sorted(PAPER_CNNS))
def test_conv_graph_steps_match_repro(name):
    assert cnn.conv_graph_steps(PAPER_CNNS[name]) == \
        jax_cnn.conv_graph_steps(JAX_CNNS[name])


def _alex(frames=2, seed=8):
    cfg, jcfg = PAPER_CNNS["CIFAR_Alex+"], JAX_CNNS["CIFAR_Alex+"]
    jparams = jax_cnn.init_cnn(jcfg, jax.random.key(0))
    params = cnn.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, device="cpu")
    x = _np(seed, frames, jcfg.input_hw, jcfg.input_hw, jcfg.cin)
    return cfg, jcfg, params, jparams, x


def test_conv_wave_graph_matches_repro():
    """A 2-frame CIFAR_Alex+ wave's conv front-end as a graph over
    ``cuda-tiled`` + ``neon-vpu`` (their plain versions): the same nodes
    and edges as repro's, and the last node's value (the flat conv4
    output) within 1e-5 of repro's wave graph on its own runtime."""
    cfg, jcfg, params, jparams, x = _alex()
    steps = cnn.conv_graph_steps(cfg)
    jss = [js for _, js in cnn.conv_jobsets(cfg, 2, name_prefix="w0/")]
    nodes, edges = cnn.conv_wave_graph(cfg, params, torch.from_numpy(x),
                                       steps, jss, 2)
    with SynergyRuntime(["cuda-tiled", "neon-vpu"], name="wave",
                        device="cpu") as rt:
        gf = rt.submit_graph(nodes, edges, name="wave0")
        vals = gf.result(TIMEOUT)
    jsteps = jax_cnn.conv_graph_steps(jcfg)
    jjss = [js for _, js in jax_cnn.conv_jobsets(jcfg, 2,
                                                 name_prefix="w0/")]
    jnodes, jedges = jax_cnn.conv_wave_graph(jcfg, jparams, jnp.asarray(x),
                                             jsteps, jjss, 2)
    with JaxSynergyRuntime(["F-PE", "S-PE"], name="wave") as jrt:
        want = jrt.submit_graph(jnodes, jedges,
                                name="wave0").result(TIMEOUT)
    assert [nd.name for nd in nodes] == [nd.name for nd in jnodes]
    assert edges == jedges
    assert vals[-1].shape == (2 * 8 * 8, 128)
    np.testing.assert_allclose(vals[-1].numpy(), np.asarray(want[-1]),
                               rtol=1e-5, atol=1e-5)
    assert gf.finish_order == list(range(len(nodes)))


def test_chip_smoke_graph_and_chain_modes_agree():
    """``chip_smoke.py``'s graph and chain modes (two waves in flight, and
    one wave at a time with a reap after every layer) and its dispatcher
    conv front-end, each wave within 1e-5 of repro's ``conv_wave_graph``
    on its own runtime."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, jcfg, params, jparams, x = _alex(frames=4, seed=9)
    xt = torch.from_numpy(x)
    waves = list(xt.split(2))
    front = cs.conv_front(cfg, params, xt)
    with SynergyRuntime(["cuda-tiled", "neon-vpu"], name="modes",
                        device="cpu") as rt:
        graph = [f.result(TIMEOUT)[-1]
                 for f in cs.graph_waves(rt, cfg, params, waves)]
        chain = cs.chain_waves(rt, cfg, params, waves)
    jsteps = jax_cnn.conv_graph_steps(jcfg)
    rows = front.shape[0] // 2
    with JaxSynergyRuntime(["F-PE", "S-PE"], name="modes") as jrt:
        for w in range(2):
            jjss = [js for _, js in jax_cnn.conv_jobsets(
                jcfg, 2, name_prefix=f"w{w}/")]
            jnodes, jedges = jax_cnn.conv_wave_graph(
                jcfg, jparams, jnp.asarray(x[2 * w:2 * w + 2]), jsteps,
                jjss, 2)
            want = np.asarray(jrt.submit_graph(
                jnodes, jedges, name=f"wave{w}").result(TIMEOUT)[-1])
            for got in (graph[w], chain[w], front[w * rows:(w + 1) * rows]):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-5)
