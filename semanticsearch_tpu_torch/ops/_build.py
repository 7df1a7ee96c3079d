"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first
use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -I csrc

under ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of the source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited kernel or header rebuilds its users. The library is
loaded with ``ctypes``: every pointer and the stream pass as ``c_void_p``,
and every entry point returns ``cudaGetLastError()`` after its launches,
which :func:`check` turns into an exception.

:func:`build_all` compiles every source at once, one ``nvcc`` process each,
so a cold start costs the slowest file rather than the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched. Callers that turn a
    document's failure into a fallback result let this one through."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (set CUDA_HOME); the "
                          "Hopper kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):  # any source may include any
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> str:
    """Wait for one nvcc and move its output into place; returns its log."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns {name: nvcc log}
    (the ``-Xptxas -v`` register and shared-memory report)."""
    with _LOCK:
        procs = {name: _start(name) for name in sources()}
        return {name: _finish(name, proc) for name, proc in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            try:
                _finish(name, _start(name))
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as exc:  # no nvcc binary, or an unloadable library
                raise KernelError(f"csrc/{name}.cu: {exc}") from exc
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise KernelError(f"{what}: CUDA launch failed with cudaError {status}")
