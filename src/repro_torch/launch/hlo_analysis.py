"""Step analysis: one rank's FLOPs, HBM bytes and collective bytes.

The reference re-derives these from the partitioned HLO of the compiled
step.  Eager PyTorch has no HLO: ``analyze_step`` runs the cell's step
once, on DTensors over the mesh, under a dispatch mode that sees what one
rank runs.  DTensor hands each op's local work to the plain kernels (the
mode steps aside for DTensor's own dispatch, and for the fake tensors its
sharding propagation runs shapes through), so every count is PER RANK:

  * FLOPs: each aten op by ``torch.utils.flop_counter``'s formulas (the
    products: 2 * M * N * K for a matmul, and the convolutions and
    attention kernels it knows);
  * HBM bytes: each aten op's tensor operands plus its outputs, views
    and allocations excepted: the reference's post-fusion traffic model
    with no fusion, as eager runs;
  * collective bytes: the operand bytes of each ``_c10d_functional`` (or
    ``c10d``) collective, by kind;
  * ``n_computations``: the number of aten ops run.

There are no loop multipliers: the Python loops run every layer.  On meta
tensors over a fake process group (``fake_group``) nothing is computed or
moved and any mesh fits one host; on real tensors over a real group the
same step gives the same counts.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op names (``_c10d_functional`` and ``c10d``) by kind
_KINDS = (("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("permute", "collective-permute"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("broadcast", "all-reduce"))
_NOBYTES = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "lift_fresh", "wait_tensor",
            "_wrap_tensor_autograd", "_local_scalar_dense"}


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _pt_leaves(obj)
               if isinstance(t, torch.Tensor))


def _kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts the plain aten ops run while it is on (see the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.n_ops = 0
        self.collectives = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)  # shape propagation, not a run
        if any(t is not torch.Tensor for t in types):
            return NotImplemented  # a subclass (DTensor) dispatches first
        out = func(*args, **kwargs)
        self.n_ops += 1
        kind = _kind(func)
        if kind is not None:
            b = _nbytes((args, kwargs)) or _nbytes(out)
            self.collectives[kind] += b
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        name = func._schema.name.split("::")[-1]
        if not func.is_view and name not in _NOBYTES:
            self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return dict(flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
                    collectives={k: float(v) for k, v in coll.items()},
                    n_computations=self.n_ops)


def analyze_step(cell, mesh, args=None) -> dict:
    """Run ``cell.fn`` once on ``args`` (None: the cell's own abstract
    arguments, placed on ``mesh`` as meta DTensors) and count what this
    rank ran: the reference's keys (``flops``, ``hbm_bytes``,
    ``collectives`` by kind and their ``total``, ``n_computations``),
    plus ``seconds``, the wall time of the run."""
    from repro_torch.launch.cells import place

    if args is None:
        args = place(cell.abstract_args, cell.in_specs, mesh)
    t0 = time.perf_counter()
    with StepCounter() as counter:
        cell.fn(*args)
    out = counter.result()
    out["seconds"] = time.perf_counter() - t0
    return out


def analyze_collectives(cell, mesh, args=None) -> dict:
    """Collective byte totals only."""
    return analyze_step(cell, mesh, args)["collectives"]


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks in this one process,
    this process being ``rank``: meshes of any size over it run the
    sharding logic and record collectives that move nothing.  Destroyed
    on exit; a process that holds a real group must not enter it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
