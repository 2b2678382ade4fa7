"""The port's GNN family (``repro_torch.models.gnn``) against the reference.

For each of the four reduced GNN configs the same weights and graph go
through both packages on the CPU: weights drawn with numpy from a seed in
the reference's tree layout (``jax.eval_shape`` of its ``init_params``),
at its init's scales, and carried into the port with
``params_from_reference``.  The reference runs once per arch (its forward
and two SGD steps, each compiled once), kept as numpy by the
module-scoped ``reference`` fixture.  The port runs on one CPU thread
(``one_thread``): at these sizes more threads only contend.  The graphs are the reference
smoke test's (``tests/test_archs_smoke.py``): ``make_cora_like(120, 480,
64, seed=2)`` for GAT and GatedGCN, ``make_molecules(4, 8, 16)`` for
SchNet and EquiformerV2.

Float32 tolerances: outputs ``rtol=atol=1e-4``; losses ``rtol=1e-5``.
Each SGD step's update ``p_new - p_old`` is held to the reference's at
``rtol=1e-3`` (see ``test_train_steps_match_reference``).  The data
generators, the sampler, the graph specs, the analytic FLOPs and the
registry are compared exactly.
"""
from __future__ import annotations

import dataclasses
import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import registry as ref_registry
from repro.configs.shapes import GNN_SHAPES as REF_GNN_SHAPES
from repro.data import graphs as ref_graphs
from repro.launch import cells as ref_cells
from repro.models.gnn import common as ref_common
from repro.models.gnn import so3 as ref_so3

from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.data.graphs import graph_to_device
from repro_torch.launch import cells
from repro_torch.models.gnn import common, equiformer, gat, so3
from repro_torch.utils.tree import tree_items, tree_leaves, tree_unflatten

GNN_ARCHS = ["equiformer-v2", "gat-cora", "gatedgcn", "schnet"]
CPU = torch.device("cpu")
LR = 1e-3  # make_gnn_train_step's default
# below this share of a leaf's largest reference gradient, a gradient is
# rounding noise of the two summation orders, and so is its update's size
GRAD_FLOOR = 1e-4
UPDATE_ULPS = 16  # see _check_update
ROOT = Path(__file__).resolve().parents[1]

# the reference's programs at the reduced sizes are tiny: LLVM's
# optimizations cost more compile time than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _setup(arch):
    """(model id, task, reference cfg, port cfg, numpy graph)."""
    ref_mod = ref_registry.get_arch(arch)
    mod = registry.get_arch(arch)
    if mod.MODEL in ("schnet", "equiformer"):
        g = ref_graphs.make_molecules(n_graphs=4, nodes_per=8, edges_per=16)
        return (mod.MODEL, "reg", ref_mod.reduced_config(),
                mod.reduced_config(), g)
    g = ref_graphs.make_cora_like(n_nodes=120, n_edges=480, d_feat=64, seed=2)
    return (mod.MODEL, "cls", ref_mod.reduced_config(d_feat=64, n_classes=7),
            mod.reduced_config(d_feat=64, n_classes=7), g)


def ref_weights(model_id, cfg, seed: int = 0):
    """numpy leaves in the reference's tree, shapes and dtypes, drawn as
    its init draws them: N(0, 1) / sqrt(fan_in), GAT's attention vectors
    N(0, 0.1), embeddings N(0, 0.3), EquiformerV2's per-l FFN
    N(0, 1) / sqrt(C)."""
    init = ref_cells._GNN_MODELS[model_id].init_params
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", None)
        if name in ("a_src", "a_dst"):
            scale = 0.1
        elif name == "embed":
            scale = 0.3
        elif len(s.shape) == 3:
            scale = 1 / np.sqrt(s.shape[1])
        else:
            scale = 1 / np.sqrt(s.shape[0])
        return (rng.standard_normal(s.shape) * scale).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _ref_graph(g):
    return {k: jnp.asarray(v) for k, v in g.items() if k != "n_graphs"}


def _reference_outputs(model_id, task, cfg, w, g) -> dict:
    """The reference's forward, and two SGD steps by one jitted step (its
    first loss is the unified loss at the carried weights)."""
    forward = jax.jit(lambda p, graph: ref_cells._GNN_MODELS[model_id]
                      .forward(p, graph, cfg), compiler_options=FAST_COMPILE)
    step = jax.jit(ref_cells.make_gnn_train_step(model_id, cfg, task),
                   compiler_options=FAST_COMPILE)
    p, graph = jax.tree.map(jnp.asarray, w), _ref_graph(g)
    p1, l1 = step(p, graph)
    p2, l2 = step(p1, graph)
    out = dict(out=forward(p, graph), loss=l1, p1=p1, l1=l1, p2=p2, l2=l2)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """``reference(arch)``: (model id, task, port cfg, weights, numpy graph,
    the reference's outputs), computed once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            model_id, task, cfg_r, cfg, g = _setup(arch)
            w = ref_weights(model_id, cfg_r)
            cache[arch] = (model_id, task, cfg, w, g,
                           _reference_outputs(model_id, task, cfg_r, w, g))
        return cache[arch]

    return get


def _port(model_id, w, cfg):
    return cells._GNN_MODELS[model_id].params_from_reference(w, cfg, CPU)


def _close(got, want, rtol=1e-4, atol=1e-4, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_matches_reference(reference, arch):
    model_id, _, cfg, w, g, ref = reference(arch)
    out = cells._GNN_MODELS[model_id].forward(
        _port(model_id, w, cfg), graph_to_device(g, CPU), cfg)
    assert tuple(out.shape) == ref["out"].shape
    _close(out, ref["out"], what="forward")


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_unified_loss_matches_reference(reference, arch):
    model_id, task, cfg, w, g, ref = reference(arch)
    loss = cells.gnn_unified_loss(model_id, _port(model_id, w, cfg),
                                  graph_to_device(g, CPU), cfg, task)
    _close(loss, ref["loss"], rtol=1e-5, atol=0, what="loss")


def _check_update(new, old_port, want_new, want_old):
    """Each weight's SGD update ``new - old_port`` against the reference's
    ``want_new - want_old`` at ``rtol=1e-3``, plus 4 float32 spacings of
    ``|old|`` (rounding the new weight) and ``UPDATE_ULPS`` float32
    epsilons of the leaf's largest update (each package's float32 gradient
    carries noise of a few ulps of the leaf's largest: against a float64
    run of the port, EquiformerV2's ``layers/1/so2/m0`` reads 6.1e-7 of
    the largest update in the port and 7.5e-7 in the reference).  The
    reference's gradient is ``-(its update) / lr``; a weight whose gradient
    is below ``GRAD_FLOOR`` of its leaf's largest (and not exactly zero) is
    summation noise and is held to ``2 lr`` instead; at least 99% of the
    weights are held, and the reference's step moves half the leaves or more
    (EquiformerV2's first layer sees only l = 0 inputs and its last
    layer's l > 0 outputs never reach the invariant readout, so their
    |m| > 0 SO(2) weights get no gradient)."""
    got = dict(tree_items(common.params_to_reference(new)))
    olds = dict(tree_items(common.params_to_reference(old_port)))
    w_old = dict(tree_items(want_old))
    n_held = n_all = n_moved = 0
    for path, want in tree_items(want_new):
        old = w_old[path].astype(np.float64)
        want_d = want.astype(np.float64) - old
        got_d = got[path].astype(np.float64) - olds[path]
        g = np.abs(want_d) / LR
        held = (g == 0) | (g > GRAD_FLOOR * g.max())
        err = np.abs(got_d - want_d)
        limit = (1e-3 * np.abs(want_d) + 4 * np.spacing(
            np.abs(old).astype(np.float32)).astype(np.float64)
            + UPDATE_ULPS * np.finfo(np.float32).eps * np.abs(want_d).max())
        bad = held & (err > limit)
        assert not bad.any(), (path, int(bad.sum()), got_d[bad][:4],
                               want_d[bad][:4])
        assert np.all(err[~held] <= 2 * LR), path
        n_moved += bool(np.any(want_d != 0))
        n_held += int(held.sum())
        n_all += held.size
    assert n_held >= 0.99 * n_all, (n_held, n_all)
    assert n_moved >= 0.5 * len(w_old), (n_moved, len(w_old))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_steps_match_reference(reference, arch):
    """Two SGD steps of ``make_gnn_train_step``: each step's loss at
    ``rtol=1e-5`` and each weight's update by ``_check_update`` (the
    second step from the port's own first-step weights)."""
    model_id, task, cfg, w, g, ref = reference(arch)
    step = cells.make_gnn_train_step(model_id, cfg, task)
    graph = graph_to_device(g, CPU)
    p0 = _port(model_id, w, cfg)
    p1, l1 = step(p0, graph)
    p2, l2 = step(p1, graph)
    _close(l1, ref["l1"], rtol=1e-5, atol=0, what="step 1 loss")
    _close(l2, ref["l2"], rtol=1e-5, atol=0, what="step 2 loss")
    _check_update(p1, p0, ref["p1"], w)
    _check_update(p2, p1, ref["p2"], ref["p1"])
    # the step is functional: its input parameters are left as they were
    for (_, a), (_, b) in zip(tree_items(common.params_to_reference(p0)),
                              tree_items(w)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_weight_carry_round_trip_is_exact(reference, arch):
    model_id, _, cfg, w, _, _ = reference(arch)
    port = _port(model_id, w, cfg)
    meta = cells._GNN_MODELS[model_id].init_params(cfg, device="meta")
    assert [p for p, _ in tree_items(port)] == [p for p, _ in tree_items(meta)]
    back = dict(tree_items(common.params_to_reference(port)))
    assert back.keys() == dict(tree_items(w)).keys()
    for path, want in tree_items(w):
        got = back[path]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), path
    # the port's own init draws the same tree, shapes, dtypes and scales
    drawn = dict(tree_items(cells._GNN_MODELS[model_id].init_params(
        cfg, device="cpu", seed=3)))
    for path, want in tree_items(w):
        t = drawn[path]
        assert tuple(t.shape) == want.shape and t.dtype == torch.float32
        if t.numel() >= 256:
            assert 0.8 < float(t.std()) / float(np.std(want)) < 1.25, path


# ---------------------------------------------------------------------------
# Segment ops at their edges
# ---------------------------------------------------------------------------

SEGMENT_GRAPHS = {
    # node 4 receives no edge; node 3 only -1-padded ones (dst 3 kept)
    "empty_and_padded": np.array(
        [[0, 1], [2, 1], [1, 2], [-1, 3], [-1, 3], [1, 0], [-1, -1],
         [2, 0]], np.int32),
    "all_invalid": np.array([[-1, 2], [3, -1], [-1, -1], [-1, 0]], np.int32),
    "random_padded": np.where(
        np.random.default_rng(5).random((40, 2)) < 0.2, -1,
        np.random.default_rng(6).integers(0, 5, (40, 2))).astype(np.int32),
}


@pytest.mark.parametrize("name", sorted(SEGMENT_GRAPHS))
def test_segment_ops_match_reference(name):
    edges = SEGMENT_GRAPHS[name]
    N, H = 5, 3
    rng = np.random.default_rng(len(name))
    data = rng.standard_normal((len(edges), H)).astype(np.float32)
    r_src, r_dst, r_valid = ref_common.edge_endpoints(jnp.asarray(edges))
    src, dst, valid = common.edge_endpoints(torch.as_tensor(edges))
    assert dst.dtype == torch.int64
    np.testing.assert_array_equal(src.numpy(), np.asarray(r_src))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(r_dst))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    d, rd = torch.as_tensor(data), jnp.asarray(data)
    _close(common.seg_sum(d, dst, N), ref_common.seg_sum(rd, r_dst, N),
           rtol=1e-6, atol=1e-6, what="seg_sum")
    mx = common.seg_max(d, dst, N)
    want = np.asarray(ref_common.seg_max(rd, r_dst, N))
    np.testing.assert_array_equal(np.isinf(mx.numpy()), np.isinf(want))
    np.testing.assert_array_equal(mx.numpy(), want)
    for v, rv in ((valid[:, None], r_valid[:, None]), (None, None)):
        _close(common.seg_softmax(d, dst, N, v),
               ref_common.seg_softmax(rd, r_dst, N, rv), rtol=1e-6,
               atol=1e-7, what=f"seg_softmax valid={v is not None}")
    deg = common.degree(torch.as_tensor(edges), N)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(
        ref_common.degree(jnp.asarray(edges), N)))
    # a masked softmax sums to 1 over a destination's valid edges, else 0
    sm = common.seg_softmax(d, dst, N, valid[:, None])
    per_node = common.seg_sum(sm, dst, N)[:, 0].numpy()
    has_valid = np.zeros(N, bool)
    has_valid[dst.numpy()[valid.numpy()]] = True
    np.testing.assert_allclose(per_node, has_valid.astype(np.float32),
                               atol=1e-6)


def test_masked_attention_weights_have_finite_zero_gradients():
    """EquiformerV2's ``exp(where(valid, logits - 20, -inf))`` is 0 with a
    zero gradient on a masked edge: padded edges and a self-loop change
    neither the loss nor any gradient."""
    cfg = registry.get_arch("equiformer-v2").reduced_config()
    g = ref_graphs.make_molecules(n_graphs=2, nodes_per=6, edges_per=8,
                                  seed=4)
    padded = dict(g, edges=np.concatenate(
        [g["edges"], [[-1, -1], [3, -1], [2, 2]]]).astype(np.int32))
    params = equiformer.init_params(cfg, device=CPU, seed=1)
    grads = []
    for graph in (g, padded):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        loss = cells.gnn_unified_loss(
            "equiformer", tree_unflatten(params, leaves),
            graph_to_device(graph, CPU), cfg, "reg")
        grads.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = grads
    _close(l1, l0, rtol=1e-6, atol=0, what="loss with masked edges")
    for a, b in zip(g0, g1):
        assert torch.isfinite(b).all()
        _close(b, a, rtol=1e-5, atol=1e-7, what="gradient with masked edges")


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def test_so3_tables_equal_reference():
    for l in range(7):
        np.testing.assert_array_equal(so3.J_block(l), ref_so3.J_block(l))
        for a, b in zip(so3.m_indices(l), ref_so3.m_indices(l)):
            np.testing.assert_array_equal(a, b)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = so3.J_tensor(6, dt, CPU).float().numpy()
        want = np.asarray(jnp.asarray(ref_so3.J_block(6), jdt), np.float32)
        np.testing.assert_array_equal(got, want)


def test_so3_rotations_match_reference():
    rng = np.random.default_rng(0)
    L, E, C = 6, 7, 3
    x = rng.standard_normal((E, (L + 1) ** 2, C)).astype(np.float32)
    vec = rng.standard_normal((E, 3)).astype(np.float32)
    vec[0] = [0.0, 0.0, 2.0]  # along +z
    vec[1] = [0.0, 0.0, -1.0]
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    a, b = so3.euler_from_edges(torch.as_tensor(vec))
    ra, rb = ref_so3.euler_from_edges(jnp.asarray(vec))
    _close(a, ra, rtol=1e-6, atol=1e-6, what="alpha")
    _close(b, rb, rtol=1e-6, atol=1e-6, what="beta")
    _close(so3.z_rotate(xt, a, L), ref_so3.z_rotate(xj, ra, L), rtol=1e-5,
           atol=1e-5, what="z_rotate")
    Jb = so3.J_tensor(L, torch.float32, CPU)
    rJb = jnp.asarray(ref_so3.J_block(L), jnp.float32)
    z = so3.rotate_to_frame(xt, a, b, L, Jb)
    _close(z, ref_so3.rotate_to_frame(xj, ra, rb, L, rJb), rtol=1e-5,
           atol=1e-5, what="rotate_to_frame")
    back = so3.rotate_from_frame(z, a, b, L, Jb)
    _close(back, x, rtol=1e-5, atol=1e-5, what="round trip")
    _close(back, ref_so3.rotate_from_frame(
        ref_so3.rotate_to_frame(xj, ra, rb, L, rJb), ra, rb, L, rJb),
        rtol=1e-5, atol=1e-5, what="round trip against the reference's")
    R = so3.rotation_matrix_l1(a, b)
    _close(R, ref_so3.rotation_matrix_l1(ra, rb), rtol=1e-5, atol=1e-6,
           what="rotation_matrix_l1")
    # an orthogonal map that sends each edge (in (y, z, x) order) to +z
    eye = torch.eye(3).expand(E, 3, 3)
    _close(R @ R.transpose(1, 2), eye, atol=1e-5, what="orthogonal")
    yzx = torch.as_tensor(vec)[:, [1, 2, 0]]
    img = (R @ yzx[..., None])[..., 0]
    _close(img[:, 1], torch.linalg.vector_norm(yzx, dim=-1), atol=1e-5,
           what="edge onto +z")


@pytest.fixture(scope="module")
def equiformer_full(reference):
    """The reduced EquiformerV2's carried weights, graph, and the reference's
    forward (the default, unrestricted float32 path)."""
    _, _, cfg, w, g, ref = reference("equiformer-v2")
    return cfg, equiformer.params_from_reference(w, cfg, CPU), \
        graph_to_device(g, CPU), ref["out"]


def test_equiformer_restrict_exact(equiformer_full):
    """The restricted rotation against the full one, the port's and the
    reference's forward: ``rtol=1e-5, atol=1e-6``."""
    cfg, p, g, ref_out = equiformer_full
    with torch.no_grad():
        o0 = equiformer.forward(p, g, cfg)
        o1 = equiformer.forward(p, g, dataclasses.replace(
            cfg, rotate_restrict=True))
    np.testing.assert_allclose(o1.numpy(), o0.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o1.numpy(), ref_out, rtol=1e-5, atol=1e-6)


def test_equiformer_bf16_edges_within_5_percent(equiformer_full):
    """``mrestrict`` (restricted rotation, bfloat16 edge tensors) against
    the float32 forward, the port's and the reference's: relative error
    under 0.05."""
    cfg, p, g, ref_out = equiformer_full
    v = dataclasses.replace(cfg, **registry.variant_overrides("mrestrict",
                                                              "gnn"))
    with torch.no_grad():
        o0 = equiformer.forward(p, g, cfg).numpy()
        o2 = equiformer.forward(p, g, v).numpy()
    assert o2.dtype == np.float32
    for want in (o0, ref_out):
        rel = np.abs(want - o2).max() / (np.abs(want).max() + 1e-9)
        assert 0 < rel < 0.05, rel


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

GENERATORS = {
    "cora_like": lambda m: m.make_cora_like(300, 1000, 50, 5, seed=4,
                                            with_pos=True),
    "product_graph": lambda m: m.make_product_graph(500, 2000, 10, 47, seed=1,
                                                    with_pos=True),
    "reddit_like": lambda m: m.make_reddit_like(400, 3000, 20, seed=3),
    "molecules": lambda m: m.make_molecules(5, 7, 12, n_species=9, seed=2),
}


def _same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_reference(name):
    _same_arrays(GENERATORS[name](graphs), GENERATORS[name](ref_graphs))


def test_neighbor_sampler_equals_reference():
    src = ref_graphs.make_reddit_like(500, 5000, 8, seed=5)
    fanouts = (5, 3)
    seeds = np.arange(16, dtype=np.int32) * 3
    nb, eb = graphs.block_shape_for(len(seeds), fanouts)
    assert (nb, eb) == ref_graphs.block_shape_for(len(seeds), fanouts)
    port = graphs.NeighborSampler(src["edges"], 500, seed=7)
    ref = ref_graphs.NeighborSampler(src["edges"], 500, seed=7)
    np.testing.assert_array_equal(port.csr.indptr, ref.csr.indptr)
    np.testing.assert_array_equal(port.csr.indices, ref.csr.indices)
    # the full budget, then one that cuts nodes and edges, then a node of
    # in-degree 0 (-1 padded); the sampler's stream advances in step
    for node_budget, edge_budget in ((nb, eb), (40, 60)):
        _same_arrays(
            port.padded_block(seeds, fanouts, node_budget, edge_budget,
                              src["nodes"], src["labels"]),
            ref.padded_block(seeds, fanouts, node_budget, edge_budget,
                             src["nodes"], src["labels"]))
    lonely = np.setdiff1d(np.arange(500), src["edges"][:, 1])
    nodes = np.concatenate([lonely[:2], seeds[:3]]).astype(np.int32)
    np.testing.assert_array_equal(port.sample_neighbors(nodes, 4),
                                  ref.sample_neighbors(nodes, 4))


def test_graph_to_device_converts_indices_once():
    g = ref_graphs.make_molecules(2, 4, 6)
    t = graph_to_device(g, CPU)
    assert "n_graphs" not in t and t.keys() == set(g) - {"n_graphs"}
    for k in ("edges", "species", "batch_seg"):
        assert t[k].dtype == torch.int64
        np.testing.assert_array_equal(t[k].numpy(), g[k])
    assert t["pos"].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graph_to_device(g)


# ---------------------------------------------------------------------------
# Cells and registry
# ---------------------------------------------------------------------------


def test_graph_specs_and_flops_equal_reference():
    """Every (GNN arch, shape) cell: the graph's shapes and float dtypes,
    the full config (each field), and ``_gnn_analytic_flops``; indices are
    int64 in the port."""
    assert REF_GNN_SHAPES == registry.SHAPE_TABLES["gnn"]
    n = 0
    for arch in GNN_ARCHS:
        ref_mod, mod = ref_registry.get_arch(arch), registry.get_arch(arch)
        assert dataclasses.asdict(mod.reduced_config()) == \
            dataclasses.asdict(ref_mod.reduced_config())
        for shape_id, shp in REF_GNN_SHAPES.items():
            for pad_to in (1, 8):
                want = ref_cells._gnn_graph_spec(shp, pad_to)
                got = cells._gnn_graph_spec(shp, pad_to)
                assert got.keys() == want.keys()
                for k, s in want.items():
                    assert tuple(got[k].shape) == tuple(s.shape), (shape_id, k)
                    assert got[k].device.type == "meta"
                    assert got[k].dtype == (
                        torch.float32 if s.dtype == jnp.float32
                        else torch.int64), (shape_id, k)
            kw = dict(d_feat=shp["d_feat"], edge_chunks=shp["edge_chunks"],
                      n_classes=shp["n_classes"] if shp["task"] == "cls"
                      else 1)
            cfg_r, cfg = ref_mod.full_config(**kw), mod.full_config(**kw)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_r)
            N, E = got["nodes"].shape[0], got["edges"].shape[0]
            assert cells._gnn_analytic_flops(
                mod.MODEL, cfg, N, E, shp["d_feat"]) == \
                ref_cells._gnn_analytic_flops(ref_mod.MODEL, cfg_r, N, E,
                                              shp["d_feat"])
            n += 1
    assert n == 16


def test_registry_equals_reference():
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)
    assert registry.SKIPS == ref_registry.SKIPS
    assert registry.VARIANTS == ref_registry.VARIANTS
    assert list(registry.all_cells(True)) == list(ref_registry.all_cells(True))
    assert list(registry.all_cells()) == list(ref_registry.all_cells())
    for arch, mod in registry.ARCHS.items():
        ref_mod = ref_registry.ARCHS[arch]
        assert (mod.FAMILY, getattr(mod, "MODEL", None)) == \
            (ref_mod.FAMILY, getattr(ref_mod, "MODEL", None))
        assert registry.shapes_for(arch) == ref_registry.shapes_for(arch)
    with pytest.raises(KeyError):
        registry.get_arch("gcn")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_gnn_training_learns():
    """GAT on a learnable synthetic Cora: over 100 steps at lr 0.5 the
    loss falls below 0.9 of the first (``test_gnn_training_learns`` of
    the reference's smoke tests, on the port)."""
    g = graph_to_device(graphs.make_cora_like(n_nodes=150, n_edges=600,
                                              d_feat=32, seed=3), CPU)
    cfg = gat.GATConfig(d_in=32, d_hidden=8, n_heads=4)
    params = gat.init_params(cfg, device=CPU, seed=0)
    step = cells.make_gnn_train_step("gat", cfg, "cls", lr=0.5)
    losses = []
    for _ in range(100):
        params, loss = step(params, g)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses[::20]


def test_train_gnn_torch_example_runs_on_the_cpu():
    """``examples/train_gnn_torch.py --device cpu``: the interval filter's
    line, and GAT's logged loss falls."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_gnn_torch", ROOT / "examples" / "train_gnn_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    buf = io.StringIO()
    with redirect_stdout(buf):
        ex.main(["--device", "cpu", "--steps", "30", "--nodes", "300"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("semantic filter relatedTo: kept ")
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 3 and losses[-1] < losses[0], lines
