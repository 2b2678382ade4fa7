"""The one traffic generator: it reads a mix's parameters and draws from the
run's ``--seed``.

A serving mix (``"driver": "serve_closed_loop"``) is a stream of facet
requests: a kind drawn by weight, a class drawn uniformly from the class
pool, and for a join kind a property drawn uniformly from the property
pool.  Draws come in fixed blocks from one generator, so the n-th
request of a seed is the same however fast the system takes them.
"""
from __future__ import annotations

import numpy as np

BLOCK = 4096
KINDS = ("class_members", "class_prop_join")


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed (negative ones fold in)."""
    return np.random.default_rng(int(seed) % (1 << 64))


class RequestStream:
    """Requests ``(kind, class, property or None)`` in the order issued."""

    def __init__(self, traffic: dict, seed: int):
        self.kinds = list(traffic["kinds"])
        unknown = set(self.kinds) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown request kinds {sorted(unknown)}")
        w = np.array([float(traffic["kinds"][k]) for k in self.kinds])
        self.kind_p = w / w.sum()
        self.classes = list(traffic["classes"])
        self.props = list(traffic["properties"])
        self.rng = rng_for(seed)
        self._buf: list = []

    def _refill(self) -> None:
        k = self.rng.choice(len(self.kinds), size=BLOCK, p=self.kind_p)
        c = self.rng.integers(0, len(self.classes), size=BLOCK)
        p = self.rng.integers(0, len(self.props), size=BLOCK)
        for ki, ci, pi in zip(k.tolist(), c.tolist(), p.tolist()):
            kind = self.kinds[ki]
            self._buf.append((kind, self.classes[ci],
                              self.props[pi] if kind == "class_prop_join"
                              else None))
        self._buf.reverse()

    def next(self):
        if not self._buf:
            self._refill()
        return self._buf.pop()

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]

