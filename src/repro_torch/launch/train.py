"""Training launcher: ``python -m repro_torch.launch.train --arch olmo-1b``.

Trains an LM arch's *reduced* config (``--reduced`` is always on, as in
the reference's launcher): config -> data -> train step ->
fault-tolerant loop -> checkpoints in the reference's format.  It runs on
CUDA, which must exist; ``--device cpu`` runs on the CPU instead.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models import lm as lm_lib
from repro_torch.train.loop import TrainLoop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("launch.train drives LM archs")
    cfg = mod.reduced_config()
    device = resolve_device(args.device)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} on {device}")

    params = lm_lib.init_params(cfg, device=device, seed=0)
    opt_state = init_opt_state(params)
    step_fn = lm_lib.make_train_step(cfg, AdamWConfig(lr=args.lr))
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=1)

    loop = TrainLoop(
        step_fn=step_fn,
        batch_at=stream.batch_at,
        ckpt=CheckpointManager(args.ckpt_dir),
        ckpt_every=args.ckpt_every,
        device=device,
    )
    loop.install_signal_handlers()
    _, _, last, hist = loop.run(params, opt_state, args.steps)
    if hist:
        print(f"done at step {last}; loss {hist[0]:.3f} -> {hist[-1]:.3f}")
    else:
        print(f"done at step {last}; the checkpoint was already there")


if __name__ == "__main__":
    main()
