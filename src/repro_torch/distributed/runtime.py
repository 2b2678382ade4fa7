"""The multi-process runtime: a process group and each process's own cards.

The counterpart of ``jax.distributed.initialize``, ``jax.process_index()``,
``jax.process_count()`` and ``jax.local_devices()``.  ``initialize`` joins
this process to a ``torch.distributed`` group (the arguments it is not
given come from the environment ``torchrun`` sets: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) and fixes the cards the process owns: with ``k``
local devices, the process of local rank p owns ``cuda:(p·k + j) % n`` for
j < k over the host's n cards, each once; with ``device="cpu"`` it owns the
CPU.  A ``ShardedKB`` built without ``devices`` then places its shards on
these cards only (``core/shard.py``): each process holds a replica of the
whole store, sharded over its own devices, as the reference's
``_local_mesh`` does.  Stores never span processes.

Backend: NCCL when no card belongs to two processes of the host, gloo
when processes share one (NCCL refuses two ranks on one card) or on the
CPU; NCCL asked for on a shared card raises.  Unless ``OMP_NUM_THREADS``
says otherwise, the processes of a host split its cores between their
PyTorch CPU threads.  The group's timeout is
finite, so a peer that died makes the others' collectives fail instead of
hanging.

``export_fleet`` is the fleet telemetry over the group: every process
writes its mergeable metrics snapshot, the group meets at a barrier, and
process 0 validates every file and aggregates them into ``fleet.json``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.obs.aggregate import aggregate
from repro_torch.obs.export import (export_mergeable_metrics,
                                    validate_metrics_snapshot)
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.metrics import REGISTRY

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class Runtime:
    """This process's place in the group."""

    process_id: int
    num_processes: int
    backend: str
    devices: tuple  # the process's own devices, torch.device with index


_RUNTIME: Runtime | None = None


def plan_devices(local_rank: int, k: int, n_cards: int) -> list:
    """The card indices the process of ``local_rank`` owns when each owns
    ``k`` of the host's ``n_cards``: ``(local_rank·k + j) % n_cards`` for
    j < k, each once."""
    if k < 1 or n_cards < 1:
        raise ValueError(f"need k >= 1 and a card, got k={k}, "
                         f"{n_cards} cards")
    return list(dict.fromkeys((local_rank * k + j) % n_cards
                              for j in range(k)))


def cards_shared(n_local: int, k: int, n_cards: int) -> bool:
    """Whether some card belongs to two of the host's ``n_local``
    processes when each owns ``k`` of ``n_cards``."""
    return n_local * min(k, n_cards) > n_cards


def choose_backend(on_cuda: bool, shared: bool, backend: str | None = None
                   ) -> str:
    """NCCL between processes with cards of their own, else gloo; an
    explicit ``backend`` is checked, never replaced."""
    if backend is None:
        return "nccl" if on_cuda and not shared else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and not on_cuda:
        raise ValueError("NCCL runs between CUDA devices; a CPU process "
                         "group takes gloo")
    if backend == "nccl" and shared:
        raise ValueError("NCCL refuses two ranks on one card, and two "
                         "processes share a card here: take gloo")
    return backend


def _from_env(value, name: str, what: str) -> str:
    if value is not None:
        return value
    if name not in os.environ:
        raise ValueError(f"no {what}: pass it or set {name} (as torchrun "
                         f"does)")
    return os.environ[name]


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_devices: int | None = None,
               backend: str | None = None, device=None,
               timeout_s: float = 60.0) -> Runtime:
    """Join the process group and fix this process's own devices.

    ``coordinator`` is ``host:port`` of process 0's rendezvous;
    ``local_devices`` the cards each process owns (1 by default);
    ``device="cpu"`` runs the group on the CPU (gloo), else the process
    needs CUDA and raises without it.  Collectives, and the rendezvous,
    give up after ``timeout_s``.
    """
    global _RUNTIME
    if _RUNTIME is not None:
        raise RuntimeError("the runtime is already initialized")
    coordinator = coordinator or (
        f"{_from_env(None, 'MASTER_ADDR', 'coordinator')}:"
        f"{_from_env(None, 'MASTER_PORT', 'coordinator port')}")
    torchrun = process_id is None
    num_processes = int(_from_env(num_processes, "WORLD_SIZE",
                                  "process count"))
    process_id = int(_from_env(process_id, "RANK", "process id"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    # the host's own processes: torchrun says so; else all on one host
    local_rank = int(os.environ.get("LOCAL_RANK", process_id)
                     if torchrun else process_id)
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes)
                  if torchrun else num_processes)
    home = resolve_device(device)  # None: CUDA, which must exist
    k = 1 if local_devices is None else int(local_devices)
    if home.type == "cuda":
        n_cards = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i)
                        for i in plan_devices(local_rank, k, n_cards))
        shared = cards_shared(n_local, k, n_cards)
    elif home.type == "cpu":
        devices, shared = (torch.device("cpu"),), n_local > 1
    else:
        raise ValueError(f"device {home}: the runtime runs on CUDA or the "
                         f"CPU")
    backend = choose_backend(home.type == "cuda", shared, backend)
    if "OMP_NUM_THREADS" not in os.environ:  # torchrun sets it; else
        # the host's processes split its cores: more threads than cores
        # make PyTorch's CPU operators spin against each other
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // n_local))
    if home.type == "cuda":  # NCCL's object collectives use it
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    _RUNTIME = Runtime(process_id, num_processes, backend, devices)
    return _RUNTIME


def is_initialized() -> bool:
    return _RUNTIME is not None


def _runtime() -> Runtime:
    if _RUNTIME is None:
        raise RuntimeError("the runtime is not initialized: call "
                           "initialize() first")
    return _RUNTIME


def local_devices() -> list:
    """This process's own devices, CUDA ones with their index."""
    return list(_runtime().devices)


def process_index() -> int:
    """This process's rank in the group (0 without a runtime)."""
    return dist.get_rank() if _RUNTIME is not None else 0


def process_count() -> int:
    """The group's size (1 without a runtime)."""
    return dist.get_world_size() if _RUNTIME is not None else 1


def barrier() -> None:
    """Every process of the group meets here (within the timeout)."""
    rt = _runtime()
    if rt.backend == "nccl":
        dist.barrier(device_ids=[rt.devices[0].index])
    else:
        dist.barrier()


def all_reduce_check() -> int:
    """The collective over the group (the reference's ``psum``): each
    process contributes its count of local devices, summed over the world
    on its first card under NCCL and on the CPU under gloo.  Returns the
    sum; raises unless it is ``process_count() · len(local_devices())``."""
    rt = _runtime()
    dev = rt.devices[0] if rt.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([len(rt.devices)], dtype=torch.int64, device=dev)
    dist.all_reduce(t)
    got = int(t.item())
    want = rt.num_processes * len(rt.devices)
    if got != want:
        raise RuntimeError(f"all_reduce summed {got} local devices, "
                           f"{rt.num_processes} processes x "
                           f"{len(rt.devices)} make {want}")
    return got


def export_fleet(metrics_dir, registry=REGISTRY) -> tuple:
    """Every process writes ``metrics-proc{rank}.json``, its mergeable
    snapshot of ``registry`` (the process ledger sampled first); after a
    barrier process 0 reads and validates every file and writes their
    aggregate, validated, to ``fleet.json``.  Returns (the fleet snapshot,
    every process's snapshot) on process 0, (None, [its own]) elsewhere."""
    rank, n = process_index(), process_count()
    out = Path(metrics_dir)
    out.mkdir(parents=True, exist_ok=True)
    LEDGER.sample()  # the hbm_bytes gauges land before the export
    mine = export_mergeable_metrics(registry, out / f"metrics-proc{rank}.json",
                                    process=str(rank))
    barrier()  # every file is written
    if rank != 0:
        return None, [mine]
    snaps = []
    for i in range(n):
        path = out / f"metrics-proc{i}.json"
        snap = json.loads(path.read_text())
        errors = validate_metrics_snapshot(snap)
        if errors:
            raise ValueError(f"{path}: " + "; ".join(errors))
        snaps.append(snap)
    fleet = aggregate(snaps)  # raises on incompatible snapshots
    errors = validate_metrics_snapshot(fleet)
    if errors:
        raise ValueError("fleet snapshot: " + "; ".join(errors))
    (out / "fleet.json").write_text(json.dumps(fleet, indent=1,
                                               sort_keys=True))
    return fleet, snaps


def shutdown() -> None:
    """Leave the process group; the runtime is uninitialized after."""
    global _RUNTIME
    if dist.is_initialized():
        dist.destroy_process_group()
    _RUNTIME = None


__all__ = ["Runtime", "plan_devices", "cards_shared", "choose_backend",
           "initialize", "is_initialized", "local_devices", "process_index",
           "process_count", "barrier", "all_reduce_check",
           "export_fleet", "shutdown"]
