"""Fault-tolerant training loop: checkpoint/restart, preemption, metrics.

  * state = (params, opt_state, step); data is a pure function of step
    (data/tokens.py), so restore(step) resumes where the run stopped;
  * SIGTERM/SIGINT set a preemption flag -> synchronous checkpoint -> clean
    exit;
  * checkpoints every ``ckpt_every`` steps via the atomic CheckpointManager,
    in the reference's format;
  * a step-time watchdog logs straggling steps (> ``straggler_factor`` x
    median).

Each batch is moved to the loop's ``device`` (None: CUDA, which must
exist).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager


@dataclass
class TrainLoop:
    step_fn: object  # (params, opt_state, batch) -> (params, opt_state, metrics)
    batch_at: object  # step -> batch dict of host arrays
    ckpt: CheckpointManager
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    log_every: int = 10
    device: object = None
    _preempted: bool = field(default=False, init=False)

    def install_signal_handlers(self):
        def handler(signum, frame):  # noqa: ARG001
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        try:
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def run(self, params, opt_state, n_steps: int, start_step: int | None = None):
        """Returns (params, opt_state, last_step, history). Resumes if a
        checkpoint exists and start_step is None."""
        device = resolve_device(self.device)
        step = 0
        if start_step is not None:
            step = start_step
        else:
            latest = self.ckpt.latest_step()
            if latest is not None:
                (params, opt_state), manifest = self.ckpt.restore(
                    (params, opt_state)
                )
                step = int(manifest["extra"].get("next_step", latest))

        history = []
        times = []
        while step < n_steps:
            t0 = time.time()
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in self.batch_at(step).items()}
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            times.append(dt)
            if len(times) > 5 and dt > self.straggler_factor * float(np.median(times)):
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(median {np.median(times):.2f}s)")
            history.append(loss)
            step += 1
            if step % self.log_every == 0:
                print(f"step {step}: loss={loss:.4f} ({dt*1000:.0f} ms)")
            if self._preempted or step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, (params, opt_state), extra={"next_step": step})
                if self._preempted:
                    print(f"[preempted] checkpointed at step {step}; exiting")
                    break
        return params, opt_state, step, history
