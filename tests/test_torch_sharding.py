"""The port's meshes, sharding rules and placements against repro's.

* Spec rules, as tuples, no ranks: ``param_pspecs`` (train and decode
  modes), ``input_pspecs`` over every cell of ``SHAPES`` (with
  ``cache_pspecs`` for the decode cells), ``opt_pspecs`` for AdamW and
  Adafactor and ``state_pspecs``, for all ten archs at their published
  widths on (16, 16), (2, 16, 16), (2, 2), (4, 2) and (2, 2, 2) meshes:
  repro's on ``jax.sharding.AbstractMesh`` (one CPU device), the port's
  on ``DeviceMesh``es over a fake process group (``FakeStore``; one
  subprocess, as the fake group is process-global).  Equal exactly.
* Placements: for a sample of leaves (reduced archs' parameters, caches
  and batches on the small meshes), every rank's shard — from
  ``distribute_tensor`` with ``to_placements``, from ``place_tree`` and
  from ``local_shard`` — equals the slice that repro's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
  device at the same mesh coordinates (8 host devices in a subprocess).
  Equal exactly.
* The production meshes need a world of 256 or 512 ranks and say so in
  any other; ``crosspod_traffic_bytes`` equals repro's for all ten archs'
  parameter shapes, compressed and not.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.launch import sharding as j_sharding
from repro.launch.train import train_state_specs as j_train_state_specs
from repro.models import input_specs as j_input_specs
from repro.models import param_specs as j_param_specs
from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adamw_init as j_adamw_init
from repro.runtime import crosspod_traffic_bytes as j_traffic
from repro_torch.configs import ARCHS
from repro_torch.launch import PartitionSpec as P
from repro_torch.launch import to_placements
from repro_torch.models import param_specs
from repro_torch.runtime import crosspod_traffic_bytes

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAMES = sorted(J_ARCHS)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
SMALL = MESHES[2:]


def _run(script: str, env: dict | None = None, timeout: int = 240) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "PYTHONPATH": SRC,
                              **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _canon(tree):
    """Spec trees as JSON: each spec a list of entries (a tuple of axes
    as a list)."""
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in tree]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

_FAKE_RULES = '''
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import (input_pspecs, opt_pspecs, param_pspecs,
                                state_pspecs, train_state_specs)
from repro_torch.models import input_specs, param_specs
from repro_torch.optim import adafactor_init, adamw_init


def canon(tree):
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in tree]


out = {}
for shape, names in json.loads(sys.argv[1]):
    size = 1
    for n in shape:
        size *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        aval = param_specs(cfg)
        pspecs = param_pspecs(cfg, aval, mesh)
        rules = {
            "train": pspecs,
            "decode": param_pspecs(cfg, aval, mesh, mode="decode"),
            "adamw": opt_pspecs(pspecs, adamw_init(aval), "adamw"),
            "adafactor": opt_pspecs(pspecs, adafactor_init(aval),
                                    "adafactor"),
            "state": state_pspecs(cfg, train_state_specs(cfg)[0], mesh),
        }
        for cell in SHAPES:
            rules["input/" + cell] = input_pspecs(
                cfg, SHAPES[cell], input_specs(cfg, SHAPES[cell]), mesh)
        out[f"{shape}/{arch}"] = {k: canon(v) for k, v in rules.items()}
    dist.destroy_process_group()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def port_rules():
    return json.loads(_run(_FAKE_RULES.replace(
        "json.loads(sys.argv[1])", repr(MESHES))))


def _repro_rules(shape, names, arch):
    mesh = AbstractMesh(shape, names)
    cfg = J_ARCHS[arch]
    aval = j_param_specs(cfg)
    pspecs = j_sharding.param_pspecs(cfg, aval, mesh)
    is_p = lambda x: isinstance(x, JP)
    canon = lambda t: jax.tree.map(
        lambda s: [list(e) if isinstance(e, tuple) else e for e in s], t,
        is_leaf=is_p)
    rules = {
        "train": pspecs,
        "decode": j_sharding.param_pspecs(cfg, aval, mesh, mode="decode"),
        "adamw": j_sharding.opt_pspecs(
            pspecs, jax.eval_shape(j_adamw_init, aval), "adamw"),
        "adafactor": j_sharding.opt_pspecs(
            pspecs, jax.eval_shape(j_adafactor_init, aval), "adafactor"),
        "state": j_train_state_specs(cfg, mesh)[1],
    }
    for cell in J_SHAPES:
        rules["input/" + cell] = j_sharding.input_pspecs(
            cfg, J_SHAPES[cell], j_input_specs(cfg, J_SHAPES[cell]), mesh)
    return {k: canon(v) for k, v in rules.items()}


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_spec_rules_equal_repro_for_every_arch(port_rules, shape, names):
    for arch in NAMES:
        got = port_rules[f"{shape}/{arch}"]
        want = json.loads(json.dumps(_repro_rules(shape, names, arch)))
        assert sorted(got) == sorted(want), arch
        for rule in want:
            assert got[rule] == want[rule], (arch, rule)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _sample_cases():
    """(mesh shape, axis names, spec, tensor shape) for leaves of reduced
    archs on the small meshes: parameters, caches and batches."""
    from repro_torch.configs import reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import input_pspecs, param_pspecs
    from repro_torch.models import input_specs
    from repro_torch.tree import tree_leaves
    cases = []
    for shape, names in SMALL:
        mesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
        for arch in ("granite-3-2b", "dbrx-132b", "zamba2-2.7b"):
            cfg = reduced(ARCHS[arch], n_layers=4)
            aval = param_specs(cfg)
            for mode in ("train", "decode"):
                specs = param_pspecs(cfg, aval, mesh, mode=mode)
                cases += [(shape, names, tuple(s), tuple(t.shape))
                          for t, s in zip(tree_leaves(aval),
                                          tree_leaves(specs))]
            for kind in ("train", "decode"):
                cell = ShapeCell("c", 16, 8, kind)
                ins = input_specs(cfg, cell)
                specs = input_pspecs(cfg, cell, ins, mesh)
                cases += [(shape, names, tuple(s), tuple(t.shape))
                          for t, s in zip(tree_leaves(ins),
                                          tree_leaves(specs))]
    out = []
    for c in cases:         # one case per distinct spec on each mesh
        if any(x[:3] == c[:3] for x in out) or not any(c[2]):
            continue
        out.append(c)
    return out


_JAX_SLICES = '''
import json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
out = []
for shape, names, spec, tshape in json.loads(sys.stdin.read()):
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(tshape))
    per = {}
    for coord in np.ndindex(*shape):
        sl = idx[mesh.devices[coord]]
        per[str(list(coord))] = [list(s.indices(n))[:2]
                                 for s, n in zip(sl, tshape)]
    out.append(per)
print(json.dumps(out))
'''

_FAKE_SHARDS = '''
import json, os, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import PartitionSpec, place_tree, to_placements
from repro_torch.launch.sharding import local_shard

cases = json.loads(sys.argv[1])
out = {}
for shape, names in {(tuple(c[0]), tuple(c[1])) for c in cases}:
    size = 1
    for n in shape:
        size *= n
    for rank in range(size):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=size)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        coord = mesh.get_coordinate()
        for i, (cs, cn, spec, tshape) in enumerate(cases):
            if (tuple(cs), tuple(cn)) != (shape, names):
                continue
            spec = PartitionSpec(*(tuple(e) if isinstance(e, list) else e
                                   for e in spec))
            n = 1
            for d in tshape:
                n *= d
            whole = torch.arange(n, dtype=torch.float32).reshape(tshape)
            dt = distribute_tensor(whole, mesh, to_placements(spec, mesh),
                                   src_data_rank=None)
            placed = place_tree({"x": whole}, {"x": spec}, mesh)["x"]
            out[f"{i}/{list(coord)}"] = [dt.to_local(), placed.to_local(),
                                   local_shard(whole, spec, mesh)]
        dist.destroy_process_group()
torch.save(out, sys.argv[2])
'''


def test_placements_give_each_rank_repro_devices_slice(tmp_path):
    cases = _sample_cases()
    assert len(cases) >= 20
    js = json.dumps([[list(s), list(n), _canon(sp), list(t)]
                     for s, n, sp, t in cases])
    want = json.loads(subprocess.run(
        [sys.executable, "-c", _JAX_SLICES], input=js, capture_output=True,
        text=True, timeout=240, check=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ).stdout)
    path = tmp_path / "shards.pt"
    _run(_FAKE_SHARDS.replace("json.loads(sys.argv[1])", repr(json.loads(
        js))).replace("sys.argv[2]", repr(str(path))))
    got = torch.load(path)
    for i, (shape, names, spec, tshape) in enumerate(cases):
        whole = torch.arange(int(np.prod(tshape)),
                             dtype=torch.float32).reshape(tshape)
        for coord in np.ndindex(*shape):
            sl = tuple(slice(a, b) for a, b in want[i][str(list(coord))])
            for shard in got[f"{i}/{list(coord)}"]:
                assert torch.equal(shard, whole[sl]), (names, spec, coord)


def test_to_placements_maps_each_named_axis_to_a_shard():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    tree = {"a": P(("pod", "data"), None, "model"), "b": P(), "c": P(None)}
    got = to_placements(tree, mesh)
    assert got == {"a": (Shard(0), Shard(0), Shard(2)),
                   "b": (Replicate(),) * 3, "c": (Replicate(),) * 3}
    with pytest.raises(ValueError, match="order"):
        to_placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        to_placements(P("model", "model"), mesh)


# ---------------------------------------------------------------------------
# meshes and local-SGD traffic
# ---------------------------------------------------------------------------

_FAKE_MESHES = '''
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import (dp_axes, make_production_mesh,
                                make_test_mesh)
try:
    make_production_mesh(device_type="cpu")
except RuntimeError as e:
    print("none:", e)
for world, multi in ((256, False), (512, True), (8, False)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        m = make_production_mesh(multi_pod=multi, device_type="cpu")
        print(world, tuple(m.shape), m.mesh_dim_names, dp_axes(m))
    except RuntimeError as e:
        print(f"{world}:", e)
    if world == 8:
        m = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
        print("test", tuple(m.shape), m.mesh_dim_names, dp_axes(m))
    dist.destroy_process_group()
'''


def test_production_meshes_need_their_world():
    lines = _run(_FAKE_MESHES).splitlines()
    assert lines[0].startswith("none:") and "no process group" in lines[0]
    assert lines[1] == "256 (16, 16) ('data', 'model') ('data',)"
    assert lines[2] == ("512 (2, 16, 16) ('pod', 'data', 'model') "
                        "('pod', 'data')")
    assert lines[3].startswith("8:") and "256 ranks" in lines[3]
    assert lines[4] == ("test (2, 2, 2) ('pod', 'data', 'model') "
                        "('pod', 'data')")


@pytest.mark.parametrize("name", NAMES)
def test_crosspod_traffic_equals_repro(name):
    jp = j_param_specs(J_ARCHS[name])
    tp = param_specs(ARCHS[name])
    for compressed in (True, False):
        assert crosspod_traffic_bytes(tp, compressed=compressed) == \
            j_traffic(jp, compressed=compressed)
    small = {"w": torch.zeros(100_000)}
    assert crosspod_traffic_bytes(small, compressed=True) < \
        0.3 * crosspod_traffic_bytes(small, compressed=False)
