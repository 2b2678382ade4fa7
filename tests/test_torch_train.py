"""The port's training substrate against the reference: the token stream,
the checkpoint format and manager, the fault-tolerant loop (resuming a
checkpoint the reference wrote, and its own kill-and-resume), and the
launcher, on the CPU.

Tolerances: a run continued in the port from the reference's step-3
checkpoint against the reference's uninterrupted run, losses
``rtol=1e-5`` and the three steps' update of each weight ``rtol=1e-3``
(see ``test_reference_checkpoint_resumes_in_the_port``); the port's own
kill-and-resume against its uninterrupted run at the reference test's
``rtol=1e-6, atol=1e-7``.
"""
from __future__ import annotations

import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.data.tokens import TokenStream as RefTokenStream
from repro.distributed.checkpoint import CheckpointManager as RefManager
from repro.models import lm as ref_lm
from repro.train.loop import TrainLoop as RefTrainLoop
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.optimizer import init_opt_state as ref_init_opt_state

from repro_torch.configs.registry import get_arch
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.train.loop import TrainLoop
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.utils.tree import tree_items, tree_leaves

CPU = torch.device("cpu")


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 4), generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.float32)},
    }


@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (512, 2, 16, 5, 0), (512, 2, 16, 5, 3), (50304, 4, 33, 1, 7),
    (97, 1, 1, 0, 123456),
])
def test_token_stream_equals_reference_bit_for_bit(vocab, batch, seq, seed,
                                                    step):
    got = TokenStream(vocab, batch, seq, seed=seed).batch_at(step)
    want = RefTokenStream(vocab, batch, seq, seed=seed).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _toy_state()
    mgr.save(10, state, extra={"next_step": 10})
    restored, manifest = mgr.restore(_toy_state(1))
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert manifest["extra"]["next_step"] == 10


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _toy_state(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_integrity_detection(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    path = mgr.save(5, _toy_state())
    f = path / "arrays.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(Exception):  # zlib/crc, zip, or the hash check
        mgr.restore(_toy_state())


def test_bfloat16_leaf_written_as_the_reference_writes_it(tmp_path):
    """The same bfloat16 bits saved by both managers give the same
    manifest hash and ``|V2`` arrays; the port restores the reference's
    file, which the reference itself cannot (``astype`` from ``|V2``)."""
    vals = np.random.default_rng(0).standard_normal((5, 3)).astype(
        jnp.bfloat16)
    ref_path = RefManager(tmp_path / "ref").save(
        1, {"w": jnp.asarray(vals), "s": jnp.int32(7)})
    bits = torch.from_numpy(vals.view(np.int16).copy()).view(torch.bfloat16)
    port = CheckpointManager(tmp_path / "port")
    port_path = port.save(1, {"w": bits, "s": torch.tensor(7,
                                                           dtype=torch.int32)})
    for p in (ref_path, port_path):
        assert np.load(p / "arrays.npz")["w"].dtype == np.dtype("V2")
    ref_manifest = (ref_path / "manifest.json").read_text()
    assert ref_manifest == (port_path / "manifest.json").read_text()
    template = {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
                "s": torch.tensor(0, dtype=torch.int32)}
    for mgr in (port, CheckpointManager(tmp_path / "ref")):
        got, _ = mgr.restore(template)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), bits.view(torch.int16))
        assert int(got["s"]) == 7
    with pytest.raises(ValueError, match="No cast function"):
        RefManager(tmp_path / "ref").restore(
            {"w": jnp.asarray(vals), "s": jnp.int32(0)})


@pytest.mark.parametrize("lr,warmup,step,grad_scale,dtype", [
    (3e-4, 100, 5, 1.0, "float32"),    # mid-warmup, the clip scales by ~1/10
    (3e-4, 1, 0, 0.01, "float32"),     # the first step, no clip
    # past warmup, cast back to bfloat16: a rate at which every weight moves
    (3e-2, 10, 30, 0.01, "bfloat16"),
])
def test_adamw_update_equals_reference(lr, warmup, step, grad_scale, dtype):
    """``adamw_update`` alone on the same seeded parameters, gradients and
    non-zero moments: the update ``p_new - p_old`` at ``rtol=1e-5`` plus 2
    spacings of ``|p_old|`` in its dtype (one rounding each side), the
    moments at ``rtol=1e-6`` with ``atol`` 1e-6 of the leaf's largest (where
    ``b1·m`` and ``(1-b1)·g`` cancel, one rounding more or less shows),
    the step and the grad norm."""
    rng = np.random.default_rng(step)
    shapes = {"a": (16, 8), "b": {"c": (8,), "d": (4, 4, 2)}}

    def draw(scale, positive=False):
        def leaf(shape):
            x = rng.standard_normal(shape) * scale
            return np.abs(x).astype(np.float32) if positive else \
                x.astype(np.float32)
        return {"a": leaf(shapes["a"]),
                "b": {k: leaf(v) for k, v in shapes["b"].items()}}

    params, grads = draw(0.1), draw(grad_scale)
    mu, nu = draw(grad_scale / 2), draw(grad_scale ** 2, positive=True)
    if dtype == "bfloat16":
        params = jax.tree.map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    kw = dict(lr=lr, warmup_steps=warmup)
    ref_p, ref_o, ref_g = jax.tree.map(np.asarray, jax.jit(
        lambda g, o, p: ref_adamw_update(g, o, p, RefAdamWConfig(**kw)))(
            grads, {"mu": mu, "nu": nu, "step": jnp.int32(step)}, params))

    def port(tree):
        def leaf(x):
            if x.dtype == np.float32:
                return torch.from_numpy(x.copy())
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return jax.tree.map(leaf, tree)

    got_p, got_o, got_g = adamw_update(
        port(grads), {"mu": port(mu), "nu": port(nu),
                      "step": torch.tensor(step, dtype=torch.int32)},
        port(params), AdamWConfig(**kw))
    assert int(got_o["step"]) == int(ref_o["step"]) == step + 1
    np.testing.assert_allclose(float(got_g), float(ref_g), rtol=1e-6)
    for name in ("mu", "nu"):
        for (_, a), (_, b) in zip(tree_items(got_o[name]),
                                  tree_items(ref_o[name])):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
    for (path, a), (_, b), (_, old) in zip(tree_items(got_p),
                                           tree_items(ref_p),
                                           tree_items(params)):
        assert str(a.dtype) == f"torch.{dtype}", path
        old = np.asarray(old, dtype=np.float64)
        got_d = a.float().numpy().astype(np.float64) - old
        want_d = np.asarray(b, dtype=np.float64) - old
        assert (want_d != 0).mean() > 0.95, path  # the weights move
        spacing = 2 * np.spacing(np.abs(old).astype(np.float32)) * (
            2.0 ** 16 if dtype == "bfloat16" else 1.0)
        bad = np.abs(got_d - want_d) > 1e-5 * np.abs(want_d) + spacing
        assert not bad.any(), (path, got_d[bad][:4], want_d[bad][:4])


def _ref_fresh(cfg):
    p = jax.jit(ref_lm.init_params, static_argnums=1)(jax.random.key(0), cfg)
    return p, ref_init_opt_state(p)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """olmo reduced, float32: the reference's TrainLoop checkpoints at step
    3; the port's TrainLoop restores it and runs to step 6; losses and
    parameters equal the reference's uninterrupted 6-step run.

    Both run AdamW at ``warmup_steps=1``, so that steps 4-6 move a weight
    by up to 9e-4, far above float32's resolution.  Each weight's update
    over those steps is held to the reference's at ``rtol=1e-3``, plus 4
    float32 spacings of the step-3 weight for each of the three roundings.
    Every weight is held: no gradient here is small enough for summation
    noise to decide its sign."""
    cfg_r = ref_get_arch("olmo-1b").reduced_config()
    cfg = get_arch("olmo-1b").reduced_config()
    stream = RefTokenStream(cfg_r.vocab, 2, 16, seed=5)
    step_fn = jax.jit(ref_lm.make_train_step(
        cfg_r, RefAdamWConfig(warmup_steps=1)))

    p, o = _ref_fresh(cfg_r)
    want_p, _, _, want_hist = RefTrainLoop(
        step_fn, stream.batch_at, RefManager(tmp_path / "a"), ckpt_every=100,
        log_every=1000).run(p, o, 6, start_step=0)
    mgr = RefManager(tmp_path / "b")
    p3, _, s, _ = RefTrainLoop(step_fn, stream.batch_at, mgr, ckpt_every=3,
                               log_every=1000).run(p, o, 3, start_step=0)
    assert s == 3 and mgr.latest_step() == 3

    params = lm.init_params(cfg, device=CPU, seed=9)  # a template only
    loop = TrainLoop(lm.make_train_step(cfg, AdamWConfig(warmup_steps=1)),
                     TokenStream(cfg.vocab, 2, 16, seed=5).batch_at,
                     CheckpointManager(tmp_path / "b"), ckpt_every=100,
                     log_every=1000, device=CPU)
    got_p, got_o, s2, hist = loop.run(params, init_opt_state(params), 6)
    assert s2 == 6 and int(got_o["step"]) == 6
    np.testing.assert_allclose(hist, want_hist[3:], rtol=1e-5, atol=0)
    got = dict(tree_items(lm.params_to_reference(got_p)))
    old_p = dict(tree_items(jax.tree.map(np.asarray, p3)))
    for path, want in tree_items(jax.tree.map(np.asarray, want_p)):
        old = old_p[path]
        want_d = want.astype(np.float64) - old
        got_d = got[path].astype(np.float64) - old
        limit = 1e-3 * np.abs(want_d) + 12 * np.spacing(np.abs(old))
        bad = np.abs(got_d - want_d) > limit
        assert not bad.any(), (path, int(bad.sum()), got_d[bad][:4],
                               want_d[bad][:4])
    # the port's step-6 checkpoint is the reference's format: it restores
    # in the reference
    restored, manifest = RefManager(tmp_path / "b").restore(
        _ref_fresh(cfg_r))
    assert manifest["step"] == 6
    np.testing.assert_array_equal(np.asarray(restored[0]["embed"]),
                                  got[("embed",)])


def test_port_kill_and_resume(tmp_path):
    """The port's loop preempted by a real SIGTERM after step 3 (it
    checkpoints and exits), then resumed to step 6, against an
    uninterrupted 6-step run."""
    cfg = get_arch("olmo-1b").reduced_config()
    stream = TokenStream(cfg.vocab, 2, 16, seed=5)
    step_fn = lm.make_train_step(cfg)

    def fresh():
        p = lm.init_params(cfg, device=CPU, seed=0)
        return p, init_opt_state(p)

    pa, _, _, hist_a = TrainLoop(
        step_fn, stream.batch_at, CheckpointManager(tmp_path / "a"),
        ckpt_every=100, log_every=1000, device=CPU).run(*fresh(), 6,
                                                        start_step=0)

    def batch_at(step):
        if step == 2:  # preempted while step 3 (index 2) runs
            os.kill(os.getpid(), signal.SIGTERM)
        return stream.batch_at(step)

    mgr = CheckpointManager(tmp_path / "b")
    loop_b = TrainLoop(step_fn, batch_at, mgr, ckpt_every=100,
                       log_every=1000, device=CPU)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        loop_b.install_signal_handlers()
        _, _, s, _ = loop_b.run(*fresh(), 6, start_step=0)
    finally:
        for sig, h in saved.items():
            signal.signal(sig, h)
    assert s == 3 and mgr.all_steps() == [3]
    pc, oc, s2, hist_c = TrainLoop(
        step_fn, stream.batch_at, mgr, ckpt_every=100, log_every=1000,
        device=CPU).run(*fresh(), 6)
    assert s2 == 6 and int(oc["step"]) == 6
    np.testing.assert_allclose(hist_c, hist_a[3:], rtol=1e-6, atol=1e-7)
    for a, b in zip(tree_leaves(pa), tree_leaves(pc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    train_launcher.main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                         str(ckpt)])
    out = capsys.readouterr().out
    assert "training olmo-1b-reduced: 2L d=64 vocab=512 on cpu" in out
    assert "done at step 4; loss" in out
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [4]
    cfg = get_arch("olmo-1b").reduced_config()
    p = lm.init_params(cfg, device=CPU)
    (p2, o2), manifest = mgr.restore((p, init_opt_state(p)))
    assert manifest["extra"] == {"next_step": 4} and int(o2["step"]) == 4
    # a second launch finds the finished run and trains nothing
    train_launcher.main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                         str(ckpt)])
    assert "already there" in capsys.readouterr().out


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("olmo-1b").reduced_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    p = lm.init_params(cfg, device=CPU)
    loop = TrainLoop(lm.make_train_step(cfg),
                     TokenStream(cfg.vocab, 2, 16).batch_at,
                     CheckpointManager(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run(p, init_opt_state(p), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--steps", "1", "--ckpt-dir",
                             str(tmp_path / "d")])
