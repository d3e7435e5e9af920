"""The port's dry run (``launch/dryrun.py``): one rank of a mesh, traced on
``meta`` tensors over a fake process group.

* The CLI, in its own process as it must run: ``--list`` prints every
  (arch, shape) cell; a production cell (mamba2-130m ``train_4k`` on the
  (16, 16) mesh of 256 fake ranks) writes an ``ok`` record with every key
  of the port's record; a full-attention arch at ``long_500k`` is skipped
  with repro's reason.
* Collectives and memory of reduced archs' steps on fake (2, 2) and
  (2, 2, 2) meshes (a subprocess: the fake group is process-global), as
  rank 0: the all-gathers, all-reduces, all-to-alls and sends of every
  step, count and bytes, equal those derived here from the pspec trees
  alone (``param_pspecs``, ``input_pspecs``, ``cache_pspecs``,
  ``opt_pspecs``) and the launchers' schemes: every step gathers each
  leaf that a data axis splits just before each use, layer by layer,
  and reduce-scatters its gradient (``_gathers_for_use``), decodes the
  rank's own cache rows (an MoE gathers its input's rows) and computes
  partitioned over 'model' (``_partitioned_blocks``; the train step's
  forward, recomputation and backward, ``_partitioned_train``, then its
  gradients' mean over the data axes and the optimizer's sums,
  ``_optimizer``); ``argument_size_in_bytes`` equals the bytes of the
  rank's placed shards and input slices.  The same for reduced internlm2,
  dbrx and zamba2 with ``fsdp=True``, whose leaves 'data' splits.
* FSDP's memory: a reduced internlm2 train step with ``fsdp=True`` and 8
  layers on the fake (2, 2) mesh peaks below the step that gathers the
  whole parameter tree over 'data' first (the parent's scheme, rebuilt
  here) by at least the gathered tree's bytes less two layers.
* The saved block inputs: a reduced granite train step of 8 layers on a
  fake (1, 4) mesh peaks lower with each rematerialized block's input
  saved as the rank's 'model' slice than with it saved whole (rebuilt
  here), by the inputs' three quarters less one gathered input.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.sharding import (_map_with_path, axes_of,
                                         input_pspecs, param_pspecs,
                                         state_pspecs)
from repro_torch.launch.train import train_state_specs
from repro_torch.models import input_specs, param_specs
from repro_torch.models.transformer import decode_rows_independent
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCH_NAMES = ("granite-3-2b", "dbrx-132b", "mamba2-130m", "zamba2-2.7b")
#: the archs traced again with ``fsdp=True`` (the reduced configs turn it
#: off), by the names of their cells
FSDP_NAMES = ("internlm2-20b", "dbrx-132b", "zamba2-2.7b")
PEAK_LAYERS = 8
#: the saved block inputs' peak: a reduced arch's layers and sequence
#: on a fake (1, 4) mesh
SLICE_ARCH, SLICE_LAYERS, SLICE_SEQ = "granite-3-2b", 8, 256
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PP_MICRO = 3
PP_SHAPE = (PP_MICRO, 2, 8)          # microbatches, rows, sequence

RECORD_KEYS = {"arch", "shape", "mesh", "kind", "memory", "hlo_accounting",
               "analyzer_version", "trace_s", "kernels", "status"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "peak_memory_in_bytes", "peak_phase", "peak_by_origin",
               "phase_peaks"}


def _cli(*args) -> subprocess.CompletedProcess:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_list_prints_every_cell():
    lines = _cli("--list").stdout.strip().splitlines()
    assert len(lines) == 40 == len(ARCHS) * len(SHAPES)
    assert lines == [f"{a} {s}" for a in ARCHS for s in SHAPES]


def test_a_production_cell_writes_an_ok_record(tmp_path):
    out = _cli("--arch", "mamba2-130m", "--shape", "train_4k", "--out",
               str(tmp_path))
    rec = json.loads((tmp_path / "mamba2-130m__train_4k__16x16.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["hlo_accounting"]) == {"flops", "hbm_bytes",
                                          "bytes_by_type", "count_by_type",
                                          "total_bytes"}
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"]) == (
        "mamba2-130m", "train_4k", "16x16", "train")
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    # the peak itemized: the arguments first, the groups summing to it;
    # the phases of a train step, the highest the peak's
    groups = mem["peak_by_origin"]
    assert groups[0]["origin"] == "arguments"
    assert groups[0]["bytes"] == mem["argument_size_in_bytes"]
    assert sum(g["bytes"] for g in groups) == mem["peak_memory_in_bytes"]
    assert set(mem["phase_peaks"]) == {"forward", "backward", "optimizer"}
    assert mem["phase_peaks"][mem["peak_phase"]] == max(
        mem["phase_peaks"].values()) == mem["peak_memory_in_bytes"]
    # one rank's shard of the fp32 AdamW state (params, m, v) and its 16
    # of the 256 rows, 4,096 tokens and labels each
    cfg = ARCHS["mamba2-130m"]
    assert mem["argument_size_in_bytes"] >= 16 * 4096 * 2 * 4
    acct = rec["hlo_accounting"]
    # the step computes partitioned over the 16 ranks of 'model': the
    # rank's share of 6·N·D on its 16 rows, at least
    assert acct["flops"] > 6 * cfg.n_params() * 16 * 4096 / 16
    assert acct["count_by_type"]["all-reduce"] > 0
    # K5 under autograd with remat: the forward and its recomputation
    assert rec["kernels"] == {"ssd": 2 * cfg.n_layers}
    assert rec["trace_s"] > 0
    assert '"status": "ok"' in out.stdout


def test_long_500k_skips_full_attention_archs():
    rec = run_cell("granite-3-2b", "long_500k", False)
    reason = ("full-attention arch: long_500k requires sub-quadratic "
              "attention (DESIGN.md)")
    assert rec == {"arch": "granite-3-2b", "shape": "long_500k",
                   "mesh": "16x16", "kind": "decode", "status": "skipped",
                   "reason": reason}
    # repro's reason, word for word
    ref = open(os.path.join(SRC, "repro", "launch", "dryrun.py")).read()
    assert '"full-attention arch: long_500k requires "\n' in ref
    assert '"sub-quadratic attention (DESIGN.md)")' in ref


# ---------------------------------------------------------------------------
# collectives and arguments on small fake meshes
# ---------------------------------------------------------------------------

_TRACE_SCRIPT = """
import contextlib, dataclasses, json, math, sys, torch
import torch.distributed as dist
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import start_fake_group, trace_cell
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.pipeline_mode import build_pp_forward, split_stages
from repro_torch.launch.serve import build_decode_step, build_prefill_step
from repro_torch.launch.sharding import (gather_data_tree, leaf_split,
                                         local_shard, local_tree, place_tree,
                                         without_model)
from repro_torch.launch.train import (_mesh_loss_and_grads, build_train_step,
                                      default_opt_cfg)
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_map
from repro_torch.models import init_model, transformer
from repro_torch.tree import tree_leaves

NAMES, FSDP, KINDS, SEQ, BATCH, MESHES, PP, PEAK, SLICE = json.loads(
    sys.argv[1])
CELLS = [(n, False) for n in NAMES] + [(n, True) for n in FSDP]


def nbytes(t):
    return t.numel() * t.element_size()


def placed_bytes(cfg, cell, mesh):
    # the rank's shards as place_tree makes them, and its input slices
    if cell.kind == "train":
        _, (aval, specs), (ins, bspecs) = build_train_step(cfg, cell, mesh)
    elif cell.kind == "prefill":
        _, (aval, specs), (ins, bspecs) = build_prefill_step(cfg, cell, mesh)
    else:
        _, (aval, specs), (ins, bspecs) = build_decode_step(cfg, cell, mesh)
    total = sum(nbytes(d.to_local())
                for d in tree_leaves(place_tree(aval, specs, mesh)))
    for k, v in ins.items():
        if k == "cache":
            total += sum(nbytes(d.to_local()) for d in tree_leaves(
                place_tree(v, bspecs[k], mesh)))
        else:
            total += nbytes(local_shard(v, bspecs[k], mesh))
    return total


def whole_gather_step(cfg, mesh, sspecs, bspecs, state, batch):
    # the train step that gathers the whole parameter tree over the data
    # axes first, then slices the gradient (the parent's scheme)
    state = tree_map(lambda d: d.clone(), state)
    pspecs = sspecs["params"]
    params = gather_data_tree(state["params"], pspecs, mesh)
    loss, grads = _mesh_loss_and_grads(cfg, mesh, bspecs, params, batch)
    del params
    shards = tree_map(lambda g, s: local_shard(g, without_model(s), mesh),
                      grads, pspecs)
    split = tree_map(lambda g, s: leaf_split(s, mesh, g.dim()), shards,
                     pspecs)
    adamw_update(default_opt_cfg(cfg), shards, local_tree(state["opt"]),
                 local_tree(state["params"]), inplace=True,
                 grad_norm=global_norm(shards, split))
    return state, loss


def peaks(mesh):
    # the traced peaks of one fsdp train step and of the whole-gather one
    cfg = dataclasses.replace(reduced(ARCHS[PEAK[0]], n_layers=PEAK[1]),
                              fsdp=True)
    cell = ShapeCell("c", SEQ, BATCH, "train")
    fn, (aval, sspecs), (ins, bspecs) = build_train_step(cfg, cell, mesh,
                                                         donate=False)
    state = place_tree(aval, sspecs, mesh)
    _, fsdp = analyze_step(fn, state, ins)
    _, whole = analyze_step(
        lambda s, b: whole_gather_step(cfg, mesh, sspecs, bspecs, s, b),
        state, ins)
    return {"fsdp": fsdp.peak_bytes, "whole": whole.peak_bytes}


out = {}
for key, (shape, names) in MESHES.items():
    start_fake_group(math.prod(shape))
    pod = shape[0] if len(shape) == 3 else 0
    mesh = make_test_mesh(*shape[-2:], pod, device_type="cpu")
    for name, fsdp in CELLS:
        cfg = dataclasses.replace(reduced(ARCHS[name]), fsdp=fsdp)
        for kind in KINDS:
            cell = ShapeCell("c", SEQ, BATCH, kind)
            rec = trace_cell(cfg, cell, mesh)
            tag = "fsdp/" if fsdp else ""
            out[f"{key}/{tag}{name}/{kind}"] = {
                "count": rec["hlo_accounting"]["count_by_type"],
                "bytes": rec["hlo_accounting"]["bytes_by_type"],
                "argument": rec["memory"]["argument_size_in_bytes"],
                "placed": placed_bytes(cfg, cell, mesh)}
    # a DTensor op: its sharding propagation (fake tensors of the global
    # shape) is no work of the step; only the local op makes a storage
    leaf = torch.empty(8, 64, 32, device="meta")
    from repro_torch.launch.sharding import P
    placed = place_tree({"w": leaf}, {"w": P("data", None, "model")}, mesh)
    _, acct = analyze_step(lambda d: d["w"].clone() * 2, placed)
    out[f"{key}/clone"] = {"peak": acct.peak_bytes, "hbm": acct.hbm_bytes,
                           "shard": nbytes(placed["w"].to_local())}
    if len(shape) == 3:
        # pipeline mode, stages over 'pod': rank 0 is stage 0
        cfg = reduced(ARCHS[PP[0]])
        fn, stages = build_pp_forward(cfg, mesh, stage_axis="pod",
                                      microbatches=PP[1][0])
        staged = split_stages(init_model(cfg, 0, device="meta"), stages)
        mbs = torch.empty((*PP[1], cfg.d_model), device="meta",
                          dtype=cfg.compute_torch_dtype)
        _, acct = analyze_step(fn, staged, mbs)
        out[f"{key}/pipeline"] = {"count": acct.coll_count_by_type,
                                  "bytes": acct.coll_bytes_by_type}
    else:
        out[f"{key}/peak"] = peaks(mesh)
    dist.destroy_process_group()

# the saved block inputs: a train step on a (1, 4) mesh, each block's
# input saved as the rank's 'model' slice and saved whole
start_fake_group(4)
mesh = make_test_mesh(1, 4, device_type="cpu")
cfg = reduced(ARCHS[SLICE[0]], n_layers=SLICE[1])
fn, (aval, sspecs), (ins, _) = build_train_step(
    cfg, ShapeCell("c", SLICE[2], BATCH, "train"), mesh, donate=False)
got = {}
for whole in (False, True):
    if whole:
        transformer._saved_input = lambda x, axis: contextlib.nullcontext()
    _, acct = analyze_step(fn, place_tree(aval, sspecs, mesh), ins)
    got["whole" if whole else "slices"] = {
        "peak": acct.peak_bytes, "phase": acct.peak_phase,
        "groups": acct.peak_by_origin,
        "gathers": acct.coll_count_by_type.get("all-gather", 0)}
out["1x4/saved_inputs"] = got
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    arg = json.dumps([ARCH_NAMES, FSDP_NAMES, KINDS, SEQ, BATCH, MESHES,
                      ["granite-3-2b", PP_SHAPE],
                      ["internlm2-20b", PEAK_LAYERS],
                      [SLICE_ARCH, SLICE_LAYERS, SLICE_SEQ]])
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_TRACE_SCRIPT), arg],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(key):
    shape, names = MESHES[key]
    return types.SimpleNamespace(shape=shape, mesh_dim_names=names)


def _split(spec, sizes) -> int:
    return math.prod(sizes[a] for e in spec for a in axes_of(e))


class _Expect:
    """The collectives of one rank's step, derived from the specs: each
    leaf sharded over k axes is gathered whole by k all-gathers (every
    axis here has 2 ranks, so the order does not change the bytes), each
    all-gather's result twice its input; an all-reduce's result is its
    tensor; a send is the tensor it sends."""

    def __init__(self, sizes):
        self.sizes = sizes
        self.count: dict = {}
        self.bytes: dict = {}

    def add(self, kind, nbytes, times=1):
        self.count[kind] = self.count.get(kind, 0) + times
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes * times

    def gather(self, nbytes, axes):
        """``nbytes`` on this rank gathered over ``axes``, one by one."""
        for a in axes:
            nbytes *= self.sizes[a]
            self.add("all-gather", nbytes)
        return nbytes

    def gather_data(self, nbytes, entry):
        """:meth:`gather` over an entry's data axes ('model' kept)."""
        axes = [a for a in axes_of(entry) if a != "model"]
        return self.gather(nbytes, axes[::-1])

    def gather_tree(self, tree, specs):
        for t, spec in zip(tree_leaves(tree), tree_leaves(specs)):
            shard = t.numel() * t.element_size() // _split(spec, self.sizes)
            self.gather(shard, [a for e in spec for a in axes_of(e)])


def _expected(name, kind, key, fsdp=False):
    mesh = _mesh(key)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = dataclasses.replace(reduced(ARCHS[name]), fsdp=fsdp)
    cell = ShapeCell("c", SEQ, BATCH, kind)
    ins = input_specs(cfg, cell)
    bspecs = input_pspecs(cfg, cell, ins, mesh)
    ex = _Expect(sizes)
    argument = sum(v.numel() * v.element_size() // _split(bspecs[k], sizes)
                   for k, v in ins.items() if k != "cache")
    if kind == "train":
        aval, _ = train_state_specs(cfg)
        sspecs = state_pspecs(cfg, aval, mesh)
        pspecs = sspecs["params"]
        _gathers_for_use(ex, cfg, aval["params"], pspecs, sizes, train=True)
        axes = axes_of(bspecs["labels"][0])
        rows = BATCH // math.prod(sizes[a] for a in axes)
        _partitioned_train(ex, cfg, sizes["model"], rows)
        # per data-parallel axis: the loss, then every leaf's gradient
        # (this rank's shard) that the axis does not split: the
        # reduce-scatter summed the others over it
        for a in axes:
            ex.add("all-reduce", 4)
            for t, spec in zip(tree_leaves(aval["params"]),
                               tree_leaves(pspecs)):
                if a not in _data_axes(spec, sizes):
                    ex.add("all-reduce", t.numel() * t.element_size()
                           // _split(spec, sizes))
        _optimizer(ex, cfg, aval, pspecs, sizes)
        argument += sum(t.numel() * t.element_size() // _split(s, sizes)
                        for t, s in zip(tree_leaves(aval),
                                        tree_leaves(sspecs)))
        return ex, argument
    mode = "decode" if kind == "decode" else "train"
    params = param_specs(cfg)
    pspecs = param_pspecs(cfg, params, mesh, mode=mode)
    _gathers_for_use(ex, cfg, params, pspecs, sizes, train=False)
    argument += sum(t.numel() * t.element_size() // _split(s, sizes)
                    for t, s in zip(tree_leaves(params),
                                    tree_leaves(pspecs)))
    name_in = "tokens" if "tokens" in bspecs else "embeds"
    axes = axes_of(bspecs[name_in][0])
    rows = BATCH // math.prod(sizes[a] for a in axes)
    if kind == "decode":
        # the rank's own cache rows, never gathered
        cache, cspecs = ins["cache"], bspecs["cache"]
        for t, spec in zip(tree_leaves(cache), tree_leaves(cspecs)):
            argument += t.numel() * t.element_size() // _split(spec, sizes)
        if not decode_rows_independent(cfg):
            # the MoE's input rows, gathered over the batch axes
            for _ in range(cfg.n_layers):
                ex.gather(rows * cfg.d_model * 4, list(axes)[::-1])
    _partitioned_blocks(ex, cfg, kind, sizes["model"], rows)
    ex.gather(rows * cfg.padded_vocab * 4, list(axes)[::-1])  # the logits
    return ex, argument


def _data_axes(spec, sizes) -> set:
    """The data axes of more than one rank that split a leaf."""
    return {a for e in spec for a in axes_of(e)
            if a != "model" and sizes[a] > 1}


def _gathers_for_use(ex, cfg, aval, pspecs, sizes, train):
    """FSDP's gathers for use: each leaf that data axes split, gathered
    over them (the minor axis first, dimension by dimension) at each
    use: a scanned layer's slice once a layer, and again where the train
    step recomputes the rematerialized block; the hybrid's shared block
    once a step; the embedding at the lookup and, tied, at the head; the
    head's weight at the head.  In the train step each gathered use's
    gradient is reduce-scattered over the same axes (the major first),
    once: the recomputation's gather is not differentiated.  A
    reduce-scatter's bytes are its result's."""
    paths = tree_leaves(_map_with_path(lambda path, _: path, aval))
    for path, t, spec in zip(paths, tree_leaves(aval), tree_leaves(pspecs)):
        dims = [[a for a in axes_of(e) if a in _data_axes(spec, sizes)]
                for e in spec]
        if not any(dims):
            continue
        nbytes = t.numel() * t.element_size() // _split(spec, sizes)
        if path.startswith(("blocks/", "encoder/")):
            uses = t.shape[0]
            nbytes //= uses
            gathers = uses * (2 if train and cfg.remat else 1)
        else:
            uses = gathers = 1 + (path == "embed" and cfg.tie_embeddings)
        for axes in dims:
            for a in reversed(axes):
                nbytes *= sizes[a]
                ex.add("all-gather", nbytes, gathers)
        if train:
            for axes in reversed(dims):
                for a in axes:
                    nbytes //= sizes[a]
                    ex.add("reduce-scatter", nbytes, uses)


def _partitioned_blocks(ex, cfg, kind, r, rows):
    """The collectives over 'model' of one partitioned prefill (``rows`` x
    SEQ tokens) or decode step (``rows`` x 1 against a SEQ-deep cache), on
    ``r`` ranks: the vocabulary-parallel embedding (an all-reduce of the
    looked-up rows) and head (an all-gather of the logit columns); per
    attention block the row-parallel output's all-reduce, and in decode
    the new token's K/V and q moved to the cache's head-dim slice (an
    all-to-all each where heads and head dim both split), the partial
    scores' all-reduce and the output moved back; per GLU MLP one
    all-to-all of ``wi``'s shard or of its activations (fewer bytes) and
    the output's all-reduce; per MoE the partial outputs' all-reduce;
    per Mamba2 mixer the norm's sum of squares and the out-projection
    summed.  Every tensor here is fp32 (the reduced configs' compute
    and param dtypes), the K/V cache bf16 (``cache_specs``)."""
    f32, d, v = 4, cfg.d_model, cfg.padded_vocab
    tokens = rows * (1 if kind == "decode" else SEQ)
    if v % r == 0:
        ex.add("all-reduce", tokens * d * f32)
        ex.add("all-gather", rows * v * f32)
    hd = cfg.resolved_head_dim if cfg.n_heads else 0

    def attn():
        heads = cfg.n_heads % r == 0 and (
            kind != "decode" or cfg.n_kv_heads % r == 0)
        if kind == "decode" and hd % r == 0:
            per_head = rows * hd * f32 // r
            if heads:           # k, v, q to the slice; o back
                ex.add("all-to-all", per_head * cfg.n_kv_heads, 2)
                ex.add("all-to-all", per_head * cfg.n_heads, 2)
            else:               # o gathered on the head dim
                ex.add("all-gather", rows * cfg.n_heads * hd * f32)
            ex.add("all-reduce", rows * cfg.n_heads * SEQ * f32)
        if heads:
            ex.add("all-reduce", tokens * d * f32)

    def mlp():
        if cfg.family == "moe":
            if cfg.n_experts % r == 0:
                ex.add("all-reduce", (BATCH if kind == "decode" else tokens)
                       * d * f32)
            return
        if (2 * cfg.d_ff) % r == 0 and cfg.d_ff % r == 0:
            # the activations where they are fewer bytes, else wi
            ex.add("all-to-all", min(tokens, d) * 2 * cfg.d_ff // r * f32)
            ex.add("all-reduce", tokens * d * f32)

    def mamba():
        if cfg.ssm_head_dim % r == 0:
            ex.add("all-reduce", tokens * f32)          # sum of squares
            ex.add("all-reduce", tokens * d * f32)      # out-projection

    if cfg.family in ("dense", "moe", "vlm"):
        for _ in range(cfg.n_layers):
            attn()
            mlp()
    elif cfg.family == "ssm":
        for _ in range(cfg.n_layers):
            mamba()
    elif cfg.family == "hybrid":
        for layer in range(cfg.n_layers):
            mamba()
            if (layer + 1) % cfg.attn_every == 0:
                attn()
                mlp()


def _partitioned_train(ex, cfg, r, rows):
    """The collectives over 'model' of one partitioned train step of
    ``rows`` x SEQ tokens on ``r`` ranks, in three passes.  The forward:
    the prefill's (:func:`_partitioned_blocks`) but the logits stay split,
    and the vocabulary-parallel loss sums the row maximum, the sum of
    exponentials and the label's logit (an all-reduce of a value a token
    each).  The recomputation of each rematerialized block (every scanned
    layer; not the hybrid's shared block) first gathers the block's input
    over 'model' (its checkpoint saved the rank's slice of it: one
    all-gather of the whole input), then runs its forward only as far as
    its last saved tensor, so it issues again every forward collective
    but the block's last all-reduce (the MLP's, or the MoE's, the
    out-projection's).  The backward: f's all-reduce of each replicated
    tensor that enters partitioned compute (x at each attention with
    heads split, MLP, MoE, Mamba2 mixer and the head; the norm's
    variance in a mixer), f's all-reduce of each whole leaf that feeds
    partitioned compute (the MoE router; the mixer's ``wbc``, ``wdt``,
    ``conv_wbc``, ``a_log``, ``dt_bias``, ``d_skip``; ``wk``/``wv``
    where the kv heads stay whole), and the inverse of each all-to-all;
    g has no backward collective."""
    f32, d, v = 4, cfg.d_model, cfg.padded_vocab
    tokens = rows * SEQ
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    heads = cfg.n_heads and cfg.n_heads % r == 0
    mlp_split = (2 * cfg.d_ff) % r == 0 and cfg.d_ff % r == 0
    regroup = min(tokens, d) * 2 * cfg.d_ff // r * f32
    h, n = (cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_state) \
        if cfg.ssm_state else (0, 0)
    whole_mixer = [d * 2 * n, d * h, 4 * 2 * n, h, h, h]

    def attn(remat):
        if not heads:
            return
        ex.add("all-reduce", tokens * d * f32, 3 if remat else 2)
        if cfg.n_kv_heads % r:          # kv heads whole: wk, wv
            ex.add("all-reduce", d * cfg.n_kv_heads * hd * f32, 2)

    def mlp(remat):
        if cfg.family == "moe":
            if cfg.n_experts % r == 0:
                ex.add("all-reduce", tokens * d * f32, 2)
                ex.add("all-reduce", d * cfg.n_experts * f32)
            return
        if mlp_split:
            ex.add("all-to-all", regroup, 3 if remat else 2)
            ex.add("all-reduce", tokens * d * f32, 2)

    def mamba():                        # always rematerialized
        if cfg.ssm_head_dim % r == 0:
            ex.add("all-reduce", tokens * f32, 3)       # sum of squares
            ex.add("all-reduce", tokens * d * f32, 2)   # out-proj, f(x)
            for nbytes in whole_mixer:
                ex.add("all-reduce", nbytes * f32)

    if v % r == 0:
        ex.add("all-reduce", tokens * d * f32, 2)   # lookup; head's f
        ex.add("all-reduce", tokens * f32, 3)       # the loss
    if r > 1:                           # each recomputed block's input
        ex.add("all-gather", tokens * d * f32, cfg.n_layers)
    if cfg.family in ("dense", "moe", "vlm"):
        for _ in range(cfg.n_layers):
            attn(True)
            mlp(True)
    elif cfg.family == "ssm":
        for _ in range(cfg.n_layers):
            mamba()
    elif cfg.family == "hybrid":
        for layer in range(cfg.n_layers):
            mamba()
            if (layer + 1) % cfg.attn_every == 0:
                attn(False)
                mlp(False)


def _optimizer(ex, cfg, aval, pspecs, sizes):
    """The optimizer's sums over the axes that split each leaf: AdamW's
    global norm, one all-reduce of a scalar for each set of axes that
    splits some leaf; Adafactor's means of ``g²`` over the last dimension
    and over dimension -2, of ``vr`` over its rows, each where an axis
    splits that dimension, and of the update's square, where one splits
    any."""
    def axes(entry):
        return [a for a in axes_of(entry) if sizes[a] > 1]

    leaves = list(zip(tree_leaves(aval["params"]), tree_leaves(pspecs)))
    if cfg.optimizer != "adafactor":
        keys = {tuple(sorted({a for e in s for a in axes(e)}))
                for _, s in leaves}
        for key in keys:
            if key:
                ex.add("all-reduce", 4, len(key))
        return
    for (t, spec), st in zip(leaves, _stats_of(aval)):
        dims = [axes(spec[i] if i < len(spec) else None)
                for i in range(t.dim())]
        local = [t.shape[i] // math.prod(sizes[a] for a in dims[i])
                 for i in range(t.dim())]
        if "vr" in st:
            for dim in (-1, -2):
                if dims[dim]:
                    out = math.prod(local) // local[dim] * 4
                    ex.add("all-reduce", out, len(dims[dim]))
            if dims[-2]:
                ex.add("all-reduce", math.prod(local[:-2]) * 4,
                       len(dims[-2]))
        if any(dims):
            ex.add("all-reduce", 4, sum(len(a) for a in dims))


def _stats_of(aval):
    """Adafactor's statistics of each leaf, in ``tree_leaves`` order."""
    out = []

    def walk(tree):
        if "vr" in tree or "v" in tree:
            out.append(tree)
            return
        for k in sorted(tree):
            walk(tree[k])

    walk(aval["opt"]["stats"])
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_collectives_and_arguments_follow_the_specs(traced, key, name, kind):
    got = traced[f"{key}/{name}/{kind}"]
    ex, argument = _expected(name, kind, key)
    assert got["count"] == ex.count
    assert got["bytes"] == ex.bytes
    assert got["argument"] == got["placed"] == argument


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", FSDP_NAMES)
@pytest.mark.parametrize("key", list(MESHES))
def test_fsdp_collectives_follow_the_specs(traced, key, name, kind):
    """With ``fsdp=True``: the gathers at each use and, in training, the
    reduce-scatters, beside the same steps' other collectives; the
    arguments, the rank's shards."""
    got = traced[f"{key}/fsdp/{name}/{kind}"]
    ex, argument = _expected(name, kind, key, fsdp=True)
    assert ex.count.get("all-gather", 0) > 0
    assert (ex.count.get("reduce-scatter", 0) > 0) == (kind == "train")
    assert got["count"] == ex.count
    assert got["bytes"] == ex.bytes
    assert got["argument"] == got["placed"] == argument


def test_fsdp_peak_stays_below_the_whole_gather_peak(traced):
    """The traced peak of live storages of a reduced internlm2 train step
    with ``fsdp=True`` and PEAK_LAYERS layers on the fake (2, 2) mesh
    stays below the whole-gather step's by at least the bytes that
    gathering the tree whole adds, less two layers' whole leaves."""
    mesh = _mesh("2x2")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = dataclasses.replace(reduced(ARCHS["internlm2-20b"],
                                      n_layers=PEAK_LAYERS), fsdp=True)
    aval, _ = train_state_specs(cfg)
    pspecs = state_pspecs(cfg, aval, mesh)["params"]
    gathered = layer = 0
    paths = tree_leaves(_map_with_path(lambda path, _: path,
                                       aval["params"]))
    for path, t, spec in zip(paths, tree_leaves(aval["params"]),
                             tree_leaves(pspecs)):
        data = math.prod(sizes[a] for a in _data_axes(spec, sizes))
        if data == 1:
            continue
        whole = t.numel() * t.element_size() // _split(spec, sizes) * data
        gathered += whole
        if path.startswith("blocks/"):
            layer += whole // PEAK_LAYERS
    peak = traced["2x2/peak"]
    assert gathered > 2 * layer > 0
    assert peak["whole"] - peak["fsdp"] >= gathered - 2 * layer, (
        peak, gathered, layer)


def test_saved_block_inputs_lower_the_train_peak(traced):
    """A reduced train step of SLICE_LAYERS layers on a fake (1, 4) mesh,
    its peak in the backward: with each rematerialized block's input
    saved as the rank's 'model' slice, the traced peak is lower than with
    the inputs saved whole by at least n(1 - 1/4) - 1 block inputs: the
    n inputs a rank kept whole are now quarters, less the one input that
    the recomputing block has gathered whole beside its own quarter; and
    the step issues one more all-gather a layer (the recomputation's)."""
    cfg = reduced(ARCHS[SLICE_ARCH], n_layers=SLICE_LAYERS)
    got = traced["1x4/saved_inputs"]
    block = BATCH * SLICE_SEQ * cfg.d_model * 4
    n = SLICE_LAYERS
    assert got["whole"]["phase"] == got["slices"]["phase"] == "backward"
    assert (got["whole"]["peak"] - got["slices"]["peak"]
            >= (n * (1 - 1 / 4) - 1) * block)
    assert got["slices"]["gathers"] == got["whole"]["gathers"] + n
    for rec in got.values():
        assert sum(g["bytes"] for g in rec["groups"]) == rec["peak"]


@pytest.mark.parametrize("key", list(MESHES))
def test_dtensor_ops_count_their_local_work(traced, key):
    """A placed leaf's clone, doubled: the peak holds the clone's and the
    product's local shards, the traffic reads and writes the shard once
    (the product; a clone is a copy), nothing of the global shape that
    DTensor's shape inference makes."""
    got = traced[f"{key}/clone"]
    assert got["shard"] == 8 * 64 * 32 * 4 // 4
    assert got["peak"] == 2 * got["shard"]
    assert got["hbm"] == 2 * got["shard"]


def test_pipeline_sends_follow_the_schedule(traced):
    """Stage 0 of ``build_pp_forward`` on the (2, 2, 2) mesh, stages over
    'pod': one send of its activation per tick (M + S - 1 ticks), then
    the outputs gathered over 'pod'."""
    cfg = reduced(ARCHS["granite-3-2b"])
    m, rows, seq = PP_SHAPE
    act = rows * seq * cfg.d_model * torch.empty(
        (), dtype=cfg.compute_torch_dtype).element_size()
    ticks = m + 2 - 1
    got = traced["2x2x2/pipeline"]
    assert got["count"] == {"collective-permute": ticks, "all-gather": 1}
    assert got["bytes"] == {"collective-permute": ticks * act,
                            "all-gather": 2 * m * act}
