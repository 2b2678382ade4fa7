"""Train a reduced OLMo-style LM for a few hundred steps with the full
fault-tolerance substrate (checkpoints, deterministic resume), on the
PyTorch port.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Kill it mid-run (Ctrl-C / SIGTERM) and re-run: it resumes from the last
checkpoint bit-exactly.  It runs on CUDA, which must exist, unless
``--device`` names another device.
"""
import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models import lm as lm_lib
from repro_torch.train.loop import TrainLoop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_example")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("olmo-1b").reduced_config()
    params = lm_lib.init_params(cfg, device=device, seed=0)
    opt = init_opt_state(params)
    n = cfg.param_count()
    print(f"model: {cfg.name} ({n:,} params) on {device}")

    loop = TrainLoop(
        step_fn=lm_lib.make_train_step(cfg, AdamWConfig(lr=3e-3)),
        batch_at=TokenStream(cfg.vocab, batch=8, seq_len=128, seed=1).batch_at,
        ckpt=CheckpointManager(args.ckpt_dir),
        ckpt_every=100,
        log_every=25,
        device=device,
    )
    loop.install_signal_handlers()
    _, _, last, hist = loop.run(params, opt, args.steps)
    if hist:
        print(f"finished at step {last}: loss {hist[0]:.3f} -> {hist[-1]:.3f}")
    else:
        print(f"finished at step {last}; the checkpoint was already there")
    return last, hist


if __name__ == "__main__":
    main()
