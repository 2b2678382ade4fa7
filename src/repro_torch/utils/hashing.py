"""Deterministic 62-bit term fingerprints.

The LiteMat pipeline separates the *string world* (host: IRIs, literals,
blank-node labels) from the *integer world* (device: encoded triples).  The
bridge is a stable 62-bit fingerprint per term:

  * ``fingerprint_string`` hashes an arbitrary IRI/literal (host side, used
    by the N-Triples parser and the ``locate``/``extract`` dictionary ops).
  * ``mix64`` produces *structural* fingerprints arithmetically from small
    integer tuples.  The synthetic generators use it so that building a
    100M-triple ABox never materializes 100M Python strings — exactly the
    role Spark's generator-side partitioning plays in the paper.

Fingerprints are confined to **61 bits** so that they split exactly into two
non-negative 31-bit int32 words — TPUs have no fast int64, so all device-side
dictionary work (sort/unique/binary search) runs on (hi, lo) int32 pairs with
lexicographic compare (see utils/pair64.py).  Collision probability for N
terms is ~N^2 / 2^62 (≈1e-3 for 100M terms, ≈1e-7 at our test scales).
"""
from __future__ import annotations

import hashlib

import numpy as np

_MASK62 = (1 << 61) - 1  # 61 bits: device hi-word < 2**30, leaving int32 sentinels free
_MASK64 = (1 << 64) - 1


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK64)
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK64)
        return z ^ (z >> np.uint64(31))


def mix64(*parts) -> np.ndarray:
    """Structural fingerprint of small-int tuples -> int64 (62-bit, >= 0).

    Each part may be a scalar or a broadcastable numpy array.  The result is
    a deterministic, well-mixed 62-bit value.
    """
    acc = np.uint64(0x243F6A8885A308D3)  # pi fractional bits: arbitrary seed
    for p in parts:
        p64 = np.asarray(p, dtype=np.uint64)
        with np.errstate(over="ignore"):
            acc = splitmix64(acc ^ splitmix64(p64))
    out = acc & np.uint64(_MASK62)
    return out.astype(np.int64)


def fingerprint_string(term: str) -> int:
    """Stable 62-bit fingerprint of an arbitrary term string (host side)."""
    h = hashlib.blake2b(term.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") & _MASK62


def fingerprint_strings(terms) -> np.ndarray:
    """Fingerprint a sequence of strings -> int64[len(terms)]."""
    return np.fromiter(
        (fingerprint_string(t) for t in terms), dtype=np.int64, count=len(terms)
    )
