"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports plain C functions that take raw device
pointers, sizes and a ``cudaStream_t`` and return the launch's
``cudaError_t``.  At first use every source is compiled by ``nvcc`` into
its own shared library — one ``nvcc`` per source, all started together —
under ``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, and loaded with ``ctypes``.  Nothing is
compiled when a module is imported: the CPU never needs the kernels.

A :class:`CudaKernel` is one kernel's binding: ``launch`` calls it on the
current PyTorch stream, raises on a nonzero ``cudaError_t`` (a refused
launch never runs, and a later synchronise would not report it) and then
adds one to ``launches``.  ``launches`` counts executions — unlike the JAX
package's ``kernel.dispatch`` counter, which fires once per call site at
trace time.  ``plain_cuda_calls`` counts calls of the kernel's plain
PyTorch version on CUDA tensors, so a run can show that the served path
never took it.  While an observability sink is registered
(:func:`repro_torch.obs.active`), each launch also emits the counter
``kernel.dispatch`` with ``kernel=<name>, impl="cuda"`` and each call of
the plain version ``impl="plain"`` (on any device): with no sink, the cost
is one boolean test.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from repro_torch.obs import trace as obs

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

#: every kernel binding, by name
KERNELS: dict[str, "CudaKernel"] = {}

_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) and
#: wall seconds of the last build, for the chip smoke run's report
build_log: dict[str, str] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel.
    Returns the build directory; raises with the compiler's output if any
    source fails."""
    global build_seconds
    import time

    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out / f"{s.stem}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out / f"{src.stem}.so")
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _libs:
        lib = ctypes.CDLL(str(build_all() / f"{stem}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
    return _libs[stem]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class CudaKernel:
    """One hand-written kernel: its source, C symbol, argument types, the
    TPU kernel it replaces, and its counters."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source  # file name under csrc/
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self.plain_cuda_calls = 0
        self._fn = None
        KERNELS[name] = self

    def _load(self):
        if self._fn is None:
            lib = _lib(Path(self.source).stem)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if the launch was refused."""
        lib, fn = self._load()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {rc} "
                f"({lib.repro_error_string(rc).decode()})")
        self.launches += 1
        if obs.active():
            obs.counter("kernel.dispatch", kernel=self.name, impl="cuda")

    def note_plain(self, t: torch.Tensor) -> None:
        """Record a call of the plain version (``plain_cuda_calls`` counts
        only those on CUDA tensors)."""
        if t.is_cuda:
            self.plain_cuda_calls += 1
        if obs.active():
            obs.counter("kernel.dispatch", kernel=self.name, impl="plain")


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_cuda_calls = 0


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes CUDA tensors only; anything else raises."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
