"""The port's LM family (``repro_torch.models``) against the reference.

For each of the five reduced LM configs the same weights and inputs go
through both packages on the CPU: weights drawn with numpy from a seed in
the reference's tree layout, at its init's scales (drawing them with the
reference's own ``init_params`` costs 1.5–5 s of compiling an arch here),
and carried into the port with ``params_from_reference``.  The reference
runs once per arch, in one jitted function (forward, train step, prefill,
decode and, for MoE archs, every MoE layer's routing), kept as numpy by
the module-scoped ``reference`` fixture.

Float32 tolerances: hidden states and logits ``rtol=atol=1e-4``; loss
and grad norm ``rtol=1e-5``; moments ``rtol=1e-3`` with ``atol`` 1e-5 of
the largest moment (the gradients of one float32 step in another
summation order); KV caches ``rtol=atol=1e-4``.  The train step's update
``p_new - p_old`` is held at ``rtol=1e-3`` (see
``test_train_step_matches_reference``).  MoE routing is compared exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import init_opt_state as ref_init_opt_state

from repro_torch.configs.registry import get_arch
from repro_torch.models import attention, layers, lm, moe
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.utils.tree import tree_items

LM_ARCHS = ["olmo-1b", "gemma-2b", "gemma3-12b", "olmoe-1b-7b",
            "deepseek-v2-236b"]
MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]
B, S = 2, 32
CPU = torch.device("cpu")
# the train step runs at the full learning rate from its first step, so
# its update (3e-4 a weight) stands well above float32's resolution and
# weight decay (3e-6 of a weight) shows in it
WARMUP_STEPS = 1
# below this share of a leaf's largest reference gradient, a gradient is
# rounding noise of the two summation orders, and so is its update's size
GRAD_FLOOR = 1e-4


def ref_weights(cfg, seed: int = 0):
    """numpy leaves in the reference's tree, shapes and dtypes, drawn as
    N(0, 1) / sqrt(fan_in) (norm scales N(0, 0.1), so ``1 + scale``
    is exercised)."""
    shapes = jax.eval_shape(lambda k: ref_lm.init_params(k, cfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = [getattr(p, "key", None) for p in path]
        shape = s.shape[1:] if keys[0] == "layers" else s.shape
        name = keys[-1]
        if name in ("ln1", "ln2", "ln_f"):
            scale = 0.1
        elif name == "embed":
            scale = 1 / np.sqrt(shape[-1])
        elif name == "wo" and keys[-2] == "attn":
            scale = 1 / np.sqrt(shape[0] * shape[1])
        elif len(shape) == 3 and keys[-2] == "ffn":  # [E, d, ff] experts
            scale = 1 / np.sqrt(shape[1])
        else:
            scale = 1 / np.sqrt(shape[0])
        return (rng.standard_normal(s.shape) * scale).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def make_batch(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": tok[:, :S], "targets": tok[:, 1:],
            "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}, \
        tok[:, S:]


def _ref_route(router, h, cfg):
    """The reference's routing expressions (``moe.py:48-64``)."""
    T = h.shape[0] * h.shape[1]
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(T * k / E * cfg.capacity_factor))
    xt = h.reshape(T, -1)
    probs = jax.nn.softmax((xt.astype(jnp.float32) @ router), axis=-1)
    _, tope = jax.lax.top_k(probs, k)
    flat_e = tope.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.zeros((T * k,), jnp.int32).at[order].set(
        jnp.arange(T * k, dtype=jnp.int32) - first.astype(jnp.int32))
    return tope, rank < C


def _ref_moe_routes(p, tokens, cfg):
    """Each stacked MoE layer's routing on the reference's own hidden
    states."""
    x = (p["embed"][tokens] * np.sqrt(cfg.d_model)).astype(cfg.jdtype)
    pos = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
    for pl_ in p.get("dense", []):
        x, _, _ = ref_lm._block(pl_, x, pos, cfg, jnp.bool_(True), True)
    routes = []
    for i in range(cfg.n_layers - cfg.dense_layers):
        pl_ = jax.tree.map(lambda a: a[i], p["layers"])
        h = ref_layers.apply_norm(cfg.norm, x, pl_.get("ln1"))
        if cfg.attn == "mla":
            a, _ = ref_attn.mla_forward(pl_["attn"], h, pos, cfg)
        else:
            a, _ = ref_attn.gqa_forward_flagged(pl_["attn"], h, pos,
                                                cfg.window, jnp.bool_(True))
        h = ref_layers.apply_norm(cfg.norm, x + a, pl_.get("ln2"))
        routes.append(_ref_route(pl_["ffn"]["router"], h, cfg))
        x, _, _ = ref_lm._block(pl_, x, pos, cfg, jnp.bool_(True), False)
    return routes


def _port_moe_routes(p, tokens, cfg):
    x = lm._embed(p, tokens, cfg)
    pos = torch.arange(tokens.shape[1]).expand(tokens.shape)
    for pl_ in p.get("dense", []):
        x, _, _ = lm._block(pl_, x, pos, cfg, True, True)
    routes = []
    for pl_ in lm.layer_views(p["layers"]):
        h = layers.apply_norm(cfg.norm, x, pl_.get("ln1"))
        if cfg.attn == "mla":
            a, _ = attention.mla_forward(pl_["attn"], h, pos, cfg)
        else:
            a, _ = attention.gqa_forward_flagged(pl_["attn"], h, pos,
                                                 cfg.window, True)
        h = layers.apply_norm(cfg.norm, x + a, pl_.get("ln2"))
        r = moe.route(pl_["ffn"]["router"], h.reshape(-1, cfg.d_model), cfg)
        routes.append((r["tope"], r["kept"]))
        x, _, _ = lm._block(pl_, x, pos, cfg, True, False)
    return routes


# the reference's programs at the reduced sizes are tiny: LLVM's
# optimizations cost more compile time than they save (no fast-math
# either way); the S=2048 blockwise forward keeps them
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def _reference_outputs(cfg, w, batch, nxt) -> dict:
    def everything(p, batch, nxt):
        x, aux = ref_lm.forward(p, batch["tokens"], cfg)
        p2, o2, m = ref_lm.make_train_step(
            cfg, RefAdamWConfig(warmup_steps=WARMUP_STEPS))(
                p, ref_init_opt_state(p), batch)
        logits, cache = ref_lm.make_prefill_step(cfg, max_seq=S + 4)(
            p, batch["tokens"])
        dlogits, dcache = ref_lm.make_decode_step(cfg)(p, cache, nxt,
                                                       jnp.int32(S))
        routes = _ref_moe_routes(p, batch["tokens"], cfg) if cfg.moe else []
        return dict(hidden=x, aux=aux, params=p2, opt=o2, metrics=m,
                    logits=logits, cache=cache, dlogits=dlogits,
                    dcache=dcache, routes=routes)

    pj = jax.tree.map(jnp.asarray, w)
    out = _jit(everything)(pj, batch, nxt)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def reference():
    """``reference(arch)``: (port cfg, weights, batch, next tokens, the
    reference's outputs), computed once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r = ref_get_arch(arch).reduced_config()
            w = ref_weights(cfg_r)
            batch, nxt = make_batch(cfg_r)
            cache[arch] = (get_arch(arch).reduced_config(), w, batch, nxt,
                           _reference_outputs(cfg_r, w, batch, nxt))
        return cache[arch]

    return get


def _port(w, cfg):
    return lm.params_from_reference(w, cfg, CPU)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=1e-4, atol=1e-4, what=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(reference, arch):
    cfg, w, batch, _, ref = reference(arch)
    x, aux = lm.forward(_port(w, cfg), _t(batch["tokens"]), cfg)
    _close(x, ref["hidden"], what="hidden")
    _close(aux, ref["aux"], rtol=1e-5, atol=1e-6, what="aux")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_matches_reference(reference, arch):
    cfg, w, batch, _, ref = reference(arch)
    loss, ce = lm.loss_fn(_port(w, cfg), {k: _t(v) for k, v in batch.items()},
                          cfg)
    _close(loss, ref["metrics"]["loss"], rtol=1e-5, atol=0, what="loss")
    _close(ce, ref["metrics"]["ce"], rtol=1e-5, atol=0, what="ce")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(reference, arch):
    """One AdamW step at ``warmup_steps=1``: the metrics, the moments, and
    each weight's update ``p_new - p_old`` against the reference's at
    ``rtol=1e-3``, plus 4 float32 spacings of ``|p_old|`` for rounding the
    new weight.  A weight whose reference gradient is below ``GRAD_FLOOR``
    of its leaf's largest (and not exactly zero) is left out of that check:
    its gradient is summation noise, so ``m̂/√v̂`` there may be any value
    in [-1, 1]; it is held instead to the bound of two full steps,
    ``2·lr``.  Gradients exactly zero (the weight decay alone) are kept."""
    cfg, w, batch, _, ref = reference(arch)
    params = _port(w, cfg)
    opt_cfg = AdamWConfig(warmup_steps=WARMUP_STEPS)
    params, opt, m = lm.make_train_step(cfg, opt_cfg)(
        params, init_opt_state(params), {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm"):
        _close(m[k], ref["metrics"][k], rtol=1e-5, atol=0, what=k)
    assert int(opt["step"]) == int(ref["opt"]["step"]) == 1
    got_p = dict(tree_items(lm.params_to_reference(params)))
    old_p = dict(tree_items(w))
    ref_mu = dict(tree_items(ref["opt"]["mu"]))  # (1 - b1) * gradient
    n_held = n_all = 0
    for path, want in tree_items(ref["params"]):
        old = old_p[path]
        want_d = want.astype(np.float64) - old
        got_d = got_p[path].astype(np.float64) - old
        g = np.abs(ref_mu[path])
        held = (g == 0) | (g > GRAD_FLOOR * g.max())
        err = np.abs(got_d - want_d)
        limit = 1e-3 * np.abs(want_d) + 4 * np.spacing(np.abs(old))
        bad = held & (err > limit)
        assert not bad.any(), (path, int(bad.sum()), got_d[bad][:4],
                               want_d[bad][:4])
        assert np.all(err[~held] <= 2 * opt_cfg.lr), path
        n_held += int(held.sum())
        n_all += held.size
    assert n_held >= 0.99 * n_all, (n_held, n_all)
    for name in ("mu", "nu"):
        got = dict(tree_items(opt[name]))
        for path, want in tree_items(ref["opt"][name]):
            atol = 1e-5 * float(np.abs(want).max())
            _close(got[path], want, rtol=1e-3, atol=atol,
                   what=f"{name} {path}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(reference, arch):
    cfg, w, batch, nxt, ref = reference(arch)
    params = _port(w, cfg)
    logits, cache = lm.make_prefill_step(cfg, max_seq=S + 4)(
        params, _t(batch["tokens"]))
    _close(logits, ref["logits"], what="prefill logits")
    assert cache.keys() == ref["cache"].keys()
    for k in cache:
        _close(cache[k], ref["cache"][k], what=f"prefill cache {k}")
    dlogits, dcache = lm.make_decode_step(cfg)(params, cache, _t(nxt), S)
    _close(dlogits, ref["dlogits"], what="decode logits")
    for k in dcache:
        _close(dcache[k], ref["dcache"][k], what=f"decode cache {k}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_equals_reference_exactly(reference, arch):
    """Every MoE layer's top-k expert ids and kept mask, each package on its
    own hidden states: a near-tie that flips shows here by name."""
    cfg, w, batch, _, ref = reference(arch)
    routes = _port_moe_routes(_port(w, cfg), _t(batch["tokens"]), cfg)
    assert len(routes) == len(ref["routes"]) == cfg.n_layers - cfg.dense_layers
    for i, ((tope, kept), (want_e, want_k)) in enumerate(
            zip(routes, ref["routes"])):
        np.testing.assert_array_equal(tope.numpy(), want_e,
                                      err_msg=f"layer {i} experts")
        np.testing.assert_array_equal(kept.numpy(), want_k,
                                      err_msg=f"layer {i} kept")
    # capacity binds somewhere, so the kept mask is not all ones
    assert not all(k.all() for _, k in ref["routes"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_weight_carry_round_trip_is_exact(reference, arch):
    cfg, w, _, _, ref = reference(arch)
    back = lm.params_to_reference(_port(w, cfg))
    for path, want in tree_items(w):
        got = dict(tree_items(back))[path]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), path
    opt = ref["opt"]
    back = lm.params_to_reference(lm.opt_state_from_reference(opt, cfg, CPU))
    assert [p for p, _ in tree_items(back)] == [p for p, _ in tree_items(opt)]
    for (_, a), (_, b) in zip(tree_items(back), tree_items(opt)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bfloat16_weight_carry_round_trip_is_exact():
    cfg_r = dataclasses.replace(ref_get_arch("olmo-1b").reduced_config(),
                                dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced_config(),
                              dtype="bfloat16")
    w = ref_weights(cfg_r)
    params = lm.params_from_reference(w, cfg, CPU)
    assert params["embed"].dtype == torch.bfloat16
    for path, got in tree_items(lm.params_to_reference(params)):
        want = dict(tree_items(w))[path]
        assert got.dtype == np.dtype("V2")
        np.testing.assert_array_equal(got.view(ml_dtypes.bfloat16), want)


def test_olmo_bfloat16_matches_reference():
    """olmo reduced in bfloat16: the forward and one train step.  bfloat16
    keeps 8 bits, so each rounding is off by up to 2^-9 relatively, and
    matrix products rounded in another order differ by a few of those:
    hidden states ``atol=rtol=0.05``, loss and grad norm ``rtol=1e-2``,
    moments 5% of the largest moment."""
    cfg_r = dataclasses.replace(ref_get_arch("olmo-1b").reduced_config(),
                                dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("olmo-1b").reduced_config(),
                              dtype="bfloat16")
    w = ref_weights(cfg_r)
    batch, _ = make_batch(cfg_r)

    def ref_fn(p, batch):
        x, _ = ref_lm.forward(p, batch["tokens"], cfg_r)
        _, o2, m = ref_lm.make_train_step(cfg_r)(p, ref_init_opt_state(p),
                                                 batch)
        return x.astype(jnp.float32), o2["mu"], m

    rx, rmu, rm = jax.tree.map(np.asarray, _jit(ref_fn)(
        jax.tree.map(jnp.asarray, w), batch))
    params = lm.params_from_reference(w, cfg, CPU)
    x, _ = lm.forward(params, _t(batch["tokens"]), cfg)
    assert x.dtype == torch.bfloat16
    _close(x.float(), rx, rtol=0.05, atol=0.05, what="hidden")
    _, opt, m = lm.make_train_step(cfg)(params, init_opt_state(params),
                                        {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm"):
        _close(m[k], rm[k], rtol=1e-2, atol=0, what=k)
    got = dict(tree_items(opt["mu"]))
    for path, want in tree_items(rmu):
        _close(got[path], want, rtol=0,
               atol=0.05 * float(np.abs(want).max()), what=f"mu {path}")


def test_blockwise_attention_over_several_tiles():
    """gemma3 reduced at S=2048: 4 query tiles of 512 and 2 key tiles of
    1024, window 8, so local layers' first key tile is fully masked for
    the later query tiles.  The port's blockwise forward against the
    reference's; its gradients (tile steps checkpointed) against the
    port's naive path's, on the first two (local) layers."""
    cfg_r = dataclasses.replace(ref_get_arch("gemma3-12b").reduced_config(),
                                attn_impl="blockwise")
    cfg = dataclasses.replace(get_arch("gemma3-12b").reduced_config(),
                              attn_impl="blockwise")
    w = ref_weights(cfg_r)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (1, 2048)) \
        .astype(np.int32)
    want, _ = jax.jit(lambda p, t: ref_lm.forward(p, t, cfg_r))(
        jax.tree.map(jnp.asarray, w), tok)
    params = lm.params_from_reference(w, cfg, CPU)
    got, _ = lm.forward(params, _t(tok), cfg)
    _close(got, np.asarray(want), what="blockwise hidden")

    probe = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32))
    grads = []
    two = dataclasses.replace(cfg, n_layers=2)  # local layers only
    params = lm.params_from_reference(
        {**w, "layers": jax.tree.map(lambda a: a[:2], w["layers"])}, two,
        CPU)
    for c in (two, dataclasses.replace(two, attn_impl="naive")):
        leaves = [t.detach().requires_grad_() for t in
                  (params["layers"]["attn"][k] for k in ("wq", "wk", "wv"))]
        p = {**params, "layers": {**params["layers"], "attn": {
            **params["layers"]["attn"], "wq": leaves[0], "wk": leaves[1],
            "wv": leaves[2]}}}
        x, _ = lm.forward(p, _t(tok), c)
        grads.append(torch.autograd.grad((x * probe).sum(), leaves))
    for gb, gn in zip(*grads):
        _close(gb, gn, rtol=1e-4, atol=1e-4 * float(gn.abs().max()),
               what="blockwise gradient")


def _ref_layers(x, pos, h, scale, mlp, embed, tgt, mask, act):
    return (ref_layers.apply_rope(x, pos), ref_layers.rms_norm(h, scale),
            ref_layers.layer_norm_nonparam(h),
            ref_layers.mlp_apply(mlp, h, act),
            ref_layers.cross_entropy_chunked(ref_lm.logits_fn, h, embed, tgt,
                                             mask, n_chunks=5))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu"])
def test_layers_match_reference(act):
    """The shared layers on their own: RoPE's tables and its rotation of
    interleaved pairs, both norms (RMSNorm scaled by ``1 + scale``), each
    MLP activation (GELU the tanh approximation) and the chunked loss."""
    rng = np.random.default_rng(7)
    cos, sin = layers.rope_freqs(16, 40)
    rcos, rsin = ref_layers.rope_freqs(16, 40)
    _close(cos, rcos, rtol=1e-6, atol=1e-6)
    _close(sin, rsin, rtol=1e-6, atol=1e-6)
    args = dict(
        x=rng.standard_normal((2, 40, 3, 16)).astype(np.float32),
        # angles under 64 rad: for thousands of radians XLA's fused cos/sin
        # and libm's round differently (by up to 6e-5 at 5,000)
        pos=rng.integers(0, 64, (2, 40)),
        h=rng.standard_normal((2, 40, 16)).astype(np.float32),
        scale=(0.1 * rng.standard_normal(16)).astype(np.float32),
        mlp={k: (rng.standard_normal(shape) / 4).astype(np.float32)
             for k, shape in (("wi", (16, 24)), ("wg", (16, 24)),
                              ("wo", (24, 16)))},
        embed=rng.standard_normal((50, 16)).astype(np.float32),
        tgt=rng.integers(0, 50, (2, 40)).astype(np.int32),
        mask=(rng.random((2, 40)) > 0.2).astype(np.float32))
    want = _jit(_ref_layers, static_argnames="act")(**args, act=act)
    t = {k: ({n: _t(w) for n, w in v.items()} if k == "mlp" else _t(v))
         for k, v in args.items()}
    got = (layers.apply_rope(t["x"], t["pos"]),
           layers.rms_norm(t["h"], t["scale"]),
           layers.layer_norm_nonparam(t["h"]),
           layers.mlp_apply(t["mlp"], t["h"], act),
           layers.cross_entropy_chunked(lm.logits_fn, t["h"], t["embed"],
                                        t["tgt"], t["mask"], n_chunks=5))
    for what, g, w, tol in zip(("rope", "rms_norm", "layer_norm", act, "CE"),
                               got, want, (1e-5, 1e-5, 1e-5, 1e-5, 1e-6)):
        _close(g, w, rtol=tol, atol=tol, what=what)
    with pytest.raises(ValueError, match="divide the chunk count"):
        layers.cross_entropy_chunked(lm.logits_fn, t["h"], t["embed"],
                                     t["tgt"], t["mask"], n_chunks=3)


def test_full_config_counts_equal_reference():
    """``param_count`` and ``model_flops_per_token`` of every full config
    (236 B parameters included; the port counts on the meta device)."""
    for arch in LM_ARCHS:
        ref_cfg = ref_get_arch(arch).full_config()
        cfg = get_arch(arch).full_config()
        assert cfg.param_count() == ref_cfg.param_count(), arch
        assert cfg.model_flops_per_token() == \
            ref_cfg.model_flops_per_token(), arch
