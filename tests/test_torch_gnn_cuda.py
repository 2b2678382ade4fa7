"""The GNN family on the card against the port's CPU runs (needs a card).

No JAX here: on a machine with a card run

    python -m pytest --noconftest -m cuda tests/test_torch_gnn_cuda.py

Without a card each test skips itself.  The four reduced archs' forward
and one SGD step run on the card and on the CPU from the same weights and
graph; the segment ops at their edges (an empty segment, a node reached
only by -1-padded edges, all edges invalid) likewise.  ``index_add`` sums
with atomics on the card, so the two sides agree to float32 tolerances:
outputs and losses ``rtol=atol=1e-4``, each weight's update ``rtol=1e-3``
(``update_share_of_limit``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.data.graphs import graph_to_device, make_cora_like, make_molecules
from repro_torch.launch.cells import _GNN_MODELS, make_gnn_train_step
from repro_torch.models.gnn import common
from repro_torch.utils.tree import tree_items

GNN_ARCHS = [a for a, m in ARCHS.items() if m.FAMILY == "gnn"]
LR = 1e-3
GRAD_FLOOR = 1e-4
UPDATE_ULPS = 16


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these tests hold the card to the CPU")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 would not be float32"
    return torch.device("cuda")


def reduced_case(arch):
    """(model id, task, reduced cfg, numpy graph) as the reference's smoke
    test draws them."""
    mod = ARCHS[arch]
    if mod.MODEL in ("schnet", "equiformer"):
        return mod.MODEL, "reg", mod.reduced_config(), make_molecules(4, 8, 16)
    return (mod.MODEL, "cls", mod.reduced_config(d_feat=64, n_classes=7),
            make_cora_like(n_nodes=120, n_edges=480, d_feat=64, seed=2))


def update_share_of_limit(new, old, want_new, want_old) -> float:
    """The largest error of the card's SGD update ``new - old`` against the
    CPU's ``want_new - want_old`` over its limit, ``1e-3 |want|`` plus 4
    float32 spacings of ``|old|`` and UPDATE_ULPS epsilons of the leaf's
    largest update; weights whose CPU gradient is under GRAD_FLOOR of the
    leaf's largest are held to ``2 lr``.  Under 1 passes."""
    got, olds = (dict(tree_items(common.params_to_reference(t)))
                 for t in (new, old))
    wold = dict(tree_items(common.params_to_reference(want_old)))
    worst = 0.0
    for path, want in tree_items(common.params_to_reference(want_new)):
        o = wold[path].astype(np.float64)
        want_d = want.astype(np.float64) - o
        got_d = got[path].astype(np.float64) - olds[path]
        g = np.abs(want_d) / LR
        held = (g == 0) | (g > GRAD_FLOOR * g.max())
        err = np.abs(got_d - want_d)
        limit = (1e-3 * np.abs(want_d)
                 + 4 * np.spacing(np.abs(o).astype(np.float32))
                 + UPDATE_ULPS * np.finfo(np.float32).eps * np.abs(want_d).max())
        if held.any():
            worst = max(worst, float((err / limit)[held].max()))
        if (~held).any():
            worst = max(worst, float(err[~held].max() / (2 * LR)))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_reduced_arch_on_the_card_matches_the_cpu(arch):
    dev = _card()
    model_id, task, cfg, g = reduced_case(arch)
    model = _GNN_MODELS[model_id]
    step = make_gnn_train_step(model_id, cfg, task)
    w = common.params_to_reference(model.init_params(cfg, device="cpu",
                                                     seed=3))
    out = {}
    for d in (torch.device("cpu"), dev):
        p = model.params_from_reference(w, cfg, d)
        graph = graph_to_device(g, d)
        with torch.no_grad():
            fwd = model.forward(p, graph, cfg).cpu()
        p1, loss = step(p, graph)
        out[d.type] = (fwd, float(loss), p, p1)
    (f0, l0, p0, q0), (f1, l1, p1, q1) = out["cpu"], out["cuda"]
    torch.testing.assert_close(f1, f0, rtol=1e-4, atol=1e-4)
    assert abs(l1 - l0) <= 1e-4 * (1 + abs(l0))
    assert update_share_of_limit(q1, p1, q0, p0) < 1.0


@pytest.mark.cuda
def test_segment_ops_on_the_card_match_the_cpu():
    dev = _card()
    graphs = [
        np.array([[0, 1], [2, 1], [1, 2], [-1, 3], [-1, 3], [1, 0], [-1, -1],
                  [2, 0]]),
        np.array([[-1, 2], [3, -1], [-1, -1], [-1, 0]]),
    ]
    N = 5
    for edges in graphs:
        data = torch.randn((len(edges), 3), generator=torch.Generator()
                           .manual_seed(len(edges)))
        outs = []
        for d in (torch.device("cpu"), dev):
            e = torch.as_tensor(edges).to(d)
            src, dst, valid = common.edge_endpoints(e)
            x = data.to(d)
            outs.append([t.cpu() for t in (
                common.seg_sum(x, dst, N), common.seg_max(x, dst, N),
                common.seg_softmax(x, dst, N, valid[:, None]),
                common.degree(e, N))])
        for a, b in zip(*outs):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        mx = outs[1][1]
        assert torch.isinf(mx[4]).all() and (mx[4] < 0).all()  # empty
        sm = outs[1][2]
        assert torch.isfinite(sm).all()
