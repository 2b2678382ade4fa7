"""Port parity, the dry-run tooling: the sharding rules, ``build_cell``,
the step analysis and the sharded steps.

* The rules' specs equal the reference's leaf for leaf (the reference's
  rules read a stand-in mesh: axis names and an empty ``devices`` array,
  no XLA devices), for the five LM archs on three meshes and the four GNN
  graph shapes; ``build_cell`` equals the reference's for every cell of
  ``all_cells()`` (the GNN index tensors are int64 here, int32 there).
* ``analyze_step`` of olmoe-1b-7b train_4k on meta tensors over a fake
  (2, 2, 2) mesh finds per-rank FLOPs between 1 and 3 times
  ``model_flops / 8`` and an all-to-all (a child process, in the
  background: ~20 s of DTensor's sharding propagation).
* The global FLOPs of reduced olmo-1b's step on a (1,) mesh are within
  10% of ``analyze_hlo`` over the reference's compiled step.
* On 4 gloo ranks, one sharded step of reduced olmo-1b, olmoe-1b-7b and
  GatedGCN equals the unsharded step to 1e-5 relative
  (``repro_torch.testing.sharded_steps``, a child process in the
  background).
The fake groups of this process are destroyed after their tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP
from repro.configs.registry import get_arch as j_get_arch
from repro.configs.shapes import GNN_SHAPES as J_GNN_SHAPES
from repro.configs.shapes import LM_SHAPES as J_LM_SHAPES
from repro.launch import cells as j_cells
from repro.launch import shardings as j_shd
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import lm as j_lm
from repro.train.optimizer import init_opt_state as j_init_opt

from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch import cells, shardings
from repro_torch.launch.hlo_analysis import analyze_step, fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["olmo-1b", "gemma-2b", "gemma3-12b", "olmoe-1b-7b",
            "deepseek-v2-236b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CHILD_TIMEOUT_S = 300


class _StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _child(argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, *argv], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def children():
    """The two child processes, started when the module's first test asks
    and run while the in-process tests run."""
    procs = {
        "dry_run": _child(["-m", "repro_torch.launch.dry_run",
                           "--cells", "reference"]),
        "steps": _child(["-m", "repro_torch.testing.sharded_steps",
                         "--world", "4"]),
    }
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _json_line(proc, key):
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"child timed out:\n{err[-3000:]}")
    assert proc.returncode == 0, err[-4000:]
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return [d[key] for d in lines if key in d] if key else lines


@pytest.fixture(scope="module")
def group(children):
    """A fake group of 512 ranks in this process for the layout meshes."""
    with fake_group(512):
        yield


def _mesh(name):
    """A mesh that only names a layout (no subgroup is made: the rules and
    ``build_cell`` read its names and sizes) and the reference's
    stand-in."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = MESHES[name]
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False)
    return mesh, _StandIn(shape, names)


def _port_items(args, specs, path=()):
    """(path, spec) for every tensor of ``args``."""
    if isinstance(args, torch.Tensor):
        return [(path, tuple(specs))]
    if isinstance(args, dict):
        return [x for k in sorted(args)
                for x in _port_items(args[k], specs[k], path + (k,))]
    if isinstance(args, (list, tuple)):
        return [x for i, (a, s) in enumerate(zip(args, specs))
                for x in _port_items(a, s, path + (i,))]
    return []


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return str(k)


def _ref_items(specs):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(_key(k) for k in path), tuple(p)) for path, p in leaves]


def _ref_leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(k) for k in path), tuple(x.shape), str(x.dtype))
            for path, x in leaves]


def _port_leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _port_leaves(t, path + (i,))]
    return []


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_equal_reference(group, arch, mesh_name):
    """Parameters, batch, opt state and both decode shapes' caches."""
    mesh, stand = _mesh(mesh_name)
    cfg = get_arch(arch).full_config()
    jcfg = j_get_arch(arch).full_config()
    p = lm.init_params(cfg, device="meta")
    jp = jax.eval_shape(lambda k: j_lm.init_params(k, jcfg),
                        jax.random.key(0))
    ps, jps = shardings.lm_param_specs(p, mesh), j_shd.lm_param_specs(jp, stand)
    assert _port_items(p, ps) == _ref_items(jps)
    assert (_port_items(p, shardings.opt_state_specs(ps)["mu"])
            == _ref_items(j_shd.opt_state_specs(jps)["mu"]))
    assert shardings.opt_state_specs(ps)["step"] == tuple(
        j_shd.opt_state_specs(jps)["step"])
    assert ({k: v for k, v in shardings.lm_batch_spec(mesh).items()}
            == {k: tuple(v) for k, v in j_shd.lm_batch_spec(stand).items()})
    for shape_id in ("decode_32k", "long_500k"):
        B, S = (J_LM_SHAPES[shape_id][k] for k in ("global_batch", "seq_len"))
        c = lm.init_cache(cfg, B, S, device="meta")
        jc = jax.eval_shape(lambda: j_lm.init_cache(jcfg, B, S))
        assert (_port_items(c, shardings.lm_cache_specs(c, mesh))
                == _ref_items(j_shd.lm_cache_specs(jc, stand))), shape_id


@pytest.mark.parametrize("shape_id", sorted(J_GNN_SHAPES))
def test_gnn_graph_specs_equal_reference(group, shape_id):
    mesh, stand = _mesh("16x16")
    shp = J_GNN_SHAPES[shape_id]
    g = cells._gnn_graph_spec(shp, pad_to=256)
    jg = j_cells._gnn_graph_spec(shp, pad_to=256)
    for nodes in (True, False):
        assert (_port_items(g, shardings.gnn_graph_specs(g, mesh, nodes))
                == _ref_items(j_shd.gnn_graph_specs(jg, stand, nodes)))


def test_placements(group):
    mesh, _ = _mesh("2x2x2")
    from torch.distributed.tensor import Replicate, Shard

    P = shardings.placements
    assert P((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0),
                                                   Shard(1))
    assert P((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert P((), mesh) == (Replicate(),) * 3
    with pytest.raises(NotImplementedError):
        P((("data", "pod"),), mesh)


@pytest.mark.parametrize("arch,shape_id", [(a, s) for a, s, _ in all_cells()])
def test_build_cell_equals_reference(group, arch, shape_id):
    mesh, stand = _mesh("16x16")
    c = cells.build_cell(arch, shape_id, mesh)
    jc = j_cells.build_cell(arch, shape_id, stand)
    assert (c.family, c.kind, c.arch_id, c.shape_id) == (
        jc.family, jc.kind, jc.arch_id, jc.shape_id)
    assert c.model_flops == jc.model_flops
    assert c.meta == jc.meta
    got, want = _port_leaves(c.abstract_args), _ref_leaves(jc.abstract_args)
    assert [x[:2] for x in got] == [x[:2] for x in want]
    for (path, _, dt), (_, _, jdt) in zip(got, want):
        # the GNN graphs' index tensors are int64 (graph_to_device's)
        assert dt == jdt or (c.family == "gnn" and (dt, jdt) == (
            "int64", "int32")), (path, dt, jdt)
    assert (_port_items(c.abstract_args, c.in_specs)
            == _ref_items(jc.in_specs))
    pl = c.shardings(mesh)
    assert len(_port_leaves(c.abstract_args)) == len(
        [x for x in _port_items(c.abstract_args, pl)])


def test_reference_mini_dry_run(children):
    """The reference's test_mini_dryrun_lm_cell, on the port: olmoe-1b-7b
    train_4k on (2, 2, 2); its own check of the all-to-all is >= 0."""
    (a,) = _json_line(children["dry_run"], "dry_run")
    assert a["arch"] == "olmoe-1b-7b" and a["mesh"] == [2, 2, 2]
    assert a["flops"] > 0
    assert 1.0 <= a["flops"] / (a["model_flops"] / 8) <= 3.0
    assert a["collectives"]["total"] > 0
    assert a["collectives"]["all-to-all"] > 0


def test_flops_match_reference_hlo(group):
    """Reduced olmo-1b's step at 2 x 128 tokens: the port's count on a (1,)
    mesh against the reference's compiled HLO on one CPU device."""
    B, S = 2, 128
    mod = get_arch("olmo-1b")
    red = dataclasses.asdict(mod.reduced_config())
    from repro_torch.launch.dry_run import with_batch

    mesh = make_mesh((1,), ("data",), "cpu")
    cell = with_batch(cells._lm_cell(mod, "train_4k", mesh, red), B, S)
    got = analyze_step(cell, mesh)
    jcfg = j_get_arch("olmo-1b").reduced_config()
    jp = jax.eval_shape(lambda k: j_lm.init_params(k, jcfg),
                        jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), np.int32),
             "targets": jax.ShapeDtypeStruct((B, S), np.int32),
             "mask": jax.ShapeDtypeStruct((B, S), np.float32)}
    hlo = jax.jit(j_lm.make_train_step(jcfg)).lower(
        jp, jax.eval_shape(j_init_opt, jp), batch).compile().as_text()
    want = analyze_hlo(hlo)["flops"]
    assert got["flops"] > 0 and abs(got["flops"] - want) <= 0.1 * want, (
        got["flops"], want)
    assert got["collectives"]["total"] == 0


def test_sharded_steps_match_unsharded(children):
    (res,) = _json_line(children["steps"], None)
    assert res["placement_order"] is True
    for case in ("olmo-1b", "olmoe-1b-7b", "gatedgcn"):
        errs = res[case]
        assert max(errs.values()) <= 1e-5, (case, errs)
