"""Exchanges between shards that live on devices of their own.

The reference's collectives run inside ``shard_map`` (``lax.all_to_all``,
``lax.all_gather``): XLA's own, not Pallas kernels.  Here every shard's
tensors live on its device (``ShardedKB.shard_devices()``: one per shard,
several shards may share one), and an exchange is plain tensor copies,
``tensor.to(device, non_blocking=True)``: a peer copy between two cards
(NVLink between H100s), none where source and destination share a device.
PyTorch orders each copy after the source's queued work and before the
destination's next, so an exchange never waits on the host.
"""
from __future__ import annotations

import contextlib

import torch


def device_ctx(device: torch.device):
    """``device`` current on the calling thread for a block: a CUDA
    device's guard, nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def all_to_all(bins: list, devices: list) -> list:
    """Per source shard ``i`` its ``S`` slices on ``devices[i]`` (a
    tensor ``[S, ...]``, or a list of tensors that may differ in length)
    -> per destination shard ``j`` the list over sources of their slice
    ``j``, each on ``devices[j]`` (``lax.all_to_all`` with split and
    concat axis 0, untiled; the sources stay apart, as runs)."""
    return [[b[j].to(d, non_blocking=True) for b in bins]
            for j, d in enumerate(devices)]


def all_gather(values: list, devices: list) -> list:
    """Per shard a tensor on its device -> per shard every shard's,
    stacked ``[S, ...]`` on its own device (``lax.all_gather``)."""
    return [torch.stack([v.to(d, non_blocking=True) for v in values])
            for d in devices]


__all__ = ["device_ctx", "all_to_all", "all_gather"]
