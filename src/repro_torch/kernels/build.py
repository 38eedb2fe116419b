"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, named by the hash of its text (and
of the headers under ``csrc/`` and the flags) under ``build/kernels/`` at
the root of the checkout, then loaded with ``ctypes``.  Nothing is compiled
at import time; a machine without ``nvcc`` can import every module.

Every launcher exported by a library has the signature
``int fn(void** ptrs, long long* ints, void* stream)`` and returns the
``cudaGetLastError()`` of its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)


class BuildRecord(NamedTuple):
    """One compiled library: its name, path, build seconds and what
    ``-Xptxas -v`` reported (registers, shared memory, spills)."""

    name: str
    path: str
    seconds: float
    ptxas: str


#: libraries built by this process, in build order (``chip_smoke.py`` prints them)
BUILDS: List[BuildRecord] = []
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def _digest(source: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256(source.encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load(name: str, source: str, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile (once per source text) and load a library."""
    flags = tuple(BASE_FLAGS) + tuple(flags)
    so = BUILD_DIR / f"{name}-{_digest(source, flags)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(source)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, so)
        BUILDS.append(BuildRecord(name, str(so), time.perf_counter() - t0, proc.stdout))
    lib = _LOADED.get(str(so))
    if lib is None:
        lib = _LOADED[str(so)] = ctypes.CDLL(str(so))
    return lib


def launcher(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, ptrs: Sequence[int], ints: Sequence[int], stream: int) -> None:
    """Call a launcher and raise on a non-zero ``cudaGetLastError()``."""
    p = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
    i = (ctypes.c_longlong * max(len(ints), 1))(*ints)
    err = fn(p, i, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch failed: cudaError {err}")
