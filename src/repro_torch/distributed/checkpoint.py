"""Fault-tolerant checkpointing in the reference's format.

Snapshots hold host arrays, never device layouts.  Writes are atomic
(tmp + rename), content-hashed, and keep-K garbage collected, so a
partially written checkpoint is never restored.

Format (the reference's): one ``arrays.npz`` per snapshot with the
tree's flattened paths as keys, plus ``manifest.json`` (step, keys,
sha256 over the sorted keys and their bytes, extra).  numpy has no
bfloat16, so a bfloat16 leaf is written as raw 2-byte words (``|V2``, the
bytes ``np.savez`` writes for the reference's bfloat16 arrays) and read
back by a view.  A float32 checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.tree import tree_items, tree_unflatten


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array; bfloat16 as raw 2-byte words (``|V2``)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def to_torch(arr, device=None, dtype=None) -> torch.Tensor:
    """A copy of a host array as a tensor; raw 2-byte words (``|V2``, or
    an ml_dtypes bfloat16 array) are bfloat16.  ``dtype`` casts after."""
    arr = np.array(arr)  # a writable copy: the tensor never aliases it
    if (arr.dtype.kind == "V" and arr.dtype.itemsize == 2) \
            or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def carry_tree(tree, template, device):
    """``tree``'s host leaves (a reference's parameter or state tree) as
    tensors on ``device`` in ``template``'s structure; every path, shape
    and dtype must be the template's.  Each leaf is a copy
    (``to_torch``): it never aliases its array."""
    want = dict(tree_items(template))
    got = dict(tree_items(tree))
    if want.keys() != got.keys():
        raise ValueError(f"tree paths differ: "
                         f"{sorted(map(str, want.keys() ^ got.keys()))}")
    out = []
    for path, leaf in want.items():
        t = to_torch(got[path], device)
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
            raise ValueError(f"{'/'.join(map(str, path))}: {tuple(t.shape)} "
                             f"{t.dtype}, want {tuple(leaf.shape)} "
                             f"{leaf.dtype}")
        out.append(t)
    return tree_unflatten(template, out)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict:
    return {_key(path): to_numpy(leaf) for path, leaf in tree_items(tree)}


def _digest(arrays) -> str:
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(arrays[k]).tobytes())
    return digest.hexdigest()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, tree, extra: dict | None = None) -> Path:
        flat = _flatten(tree)
        manifest = dict(
            step=step,
            keys=sorted(flat.keys()),
            sha256=_digest(flat),
            extra=extra or {},
        )
        final = self._step_dir(step)
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            d = self._step_dir(s)
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    def all_steps(self):
        out = []
        for d in self.dir.iterdir():
            if d.name.startswith("step_") and (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template_tree, step: int | None = None,
                verify: bool = True):
        """Restore onto the template's structure: each leaf a tensor on its
        template leaf's device and in its dtype.  Returns (tree, manifest).
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as data:
            arrays = {k: data[k] for k in data.files}
        if verify and _digest(arrays) != manifest["sha256"]:
            raise IOError(f"checkpoint {d} failed integrity check")
        out = []
        for path, leaf in tree_items(template_tree):
            key = _key(path)
            arr = arrays[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            out.append(to_torch(arr, leaf.device, leaf.dtype))
        return tree_unflatten(template_tree, out), manifest
