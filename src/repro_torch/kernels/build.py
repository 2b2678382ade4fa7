"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries land in ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of their source, so an edited
kernel is rebuilt and an unchanged one is reused.  Nothing builds at
import: the first launch of a kernel builds it, and ``build_all`` builds
every source at once, one ``nvcc`` per source, all started together.

A wrapper launches through an ``Entry``: its C function, resolved on the
first call and kept, called on the device of the wrapper's tensors with
the raw pointer of PyTorch's current stream there, its returned
``cudaGetLastError`` checked; then it counts the launch with
``launched``.  The CUDA runtime's current device belongs to the calling
thread, and the C entries zero buffers and launch on it, so ``Entry``
makes the tensors' device current for the call when it is not already
(and puts the thread's back after).  The wrappers' own argument checks
are plain attribute tests, so one launch costs the caller a few
microseconds of Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("stream_compact", "pair_search", "merge_path", "interval_filter",
           "msc_select", "closure_expand")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}  # source name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``name`` -> (popen, tmp path, target) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> None:
    """Compile every named source concurrently (skips up-to-date ones)."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


class Entry:
    """C entry point ``symbol`` of ``csrc/<source>.cu``, taking the stream
    last and returning the launch's ``cudaGetLastError``.  The typed ctypes
    function is resolved (and the source built) on the first call, then
    kept.  ``entry(device, *args)`` calls it with ``args`` and the current
    stream of ``device`` (a CUDA device with its index), that device current
    on the calling thread for the call; it raises if the launch reported an
    error."""

    __slots__ = ("source", "symbol", "argtypes", "_fn")

    def __init__(self, source: str, symbol: str, argtypes):
        self.source, self.symbol, self.argtypes = source, symbol, list(argtypes)
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        current = torch._C._cuda_getDevice()
        index = current if device.index is None else device.index
        if index == current:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:  # the thread's device is another card's: switch for the call
            torch._C._cuda_setDevice(index)
            try:
                err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
            finally:
                torch._C._cuda_setDevice(current)
        if err:
            raise RuntimeError(f"CUDA launch of {self.symbol} on cuda:{index} "
                               f"failed with error {err}")


def stream(device: torch.device) -> int:
    """The raw pointer of PyTorch's current stream on ``device`` (a CUDA
    device with its index), as kernels launch on it: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object per launch.  A device without an index is the
    current one."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_COUNT_LOCK = threading.Lock()
DEVICE_LAUNCHES: dict = {}  # (wrapper name, device index) -> launches


def launched(wrapper, device: torch.device) -> None:
    """Add one to ``wrapper.launches``, the count of the wrapper's kernel
    launches, and to its count on ``device`` in ``DEVICE_LAUNCHES``: under
    a lock, as wrappers launch from several threads (the serving runtime's
    workers)."""
    key = (wrapper.__name__, device.index)
    with _COUNT_LOCK:
        wrapper.launches += 1
        DEVICE_LAUNCHES[key] = DEVICE_LAUNCHES.get(key, 0) + 1


def require_cuda(first: torch.Tensor, *rest: torch.Tensor) -> torch.device:
    """Every argument is a CUDA tensor on one device (else raise); returns it."""
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"kernel arguments must be CUDA tensors, got {dev}")
    for t in rest:
        if t.device != dev:
            raise ValueError(f"kernel arguments must share one CUDA device, "
                             f"got {dev} and {t.device}")
    return dev
