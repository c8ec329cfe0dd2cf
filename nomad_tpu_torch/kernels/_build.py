"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and no PyTorch headers (it
may include the shared `csrc/*.cuh`); it is compiled with nvcc into `build/lib<name>-<hash>.so` at the repository
root at first use and loaded with ctypes. The file name carries a hash of
the source and flags, so an edited source builds anew and a stale library
is never loaded. Raises when nvcc is missing or the build fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

#: sm_90a for Hopper; no fast math, and no FMA contraction so a*b+c
#: rounds as the plain PyTorch version and XLA round it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")

_LOCKS_GUARD = threading.Lock()
#: one lock per library: a library builds once, different ones in parallel
_LOCKS: dict = {}

#: name → (seconds the build took, 0.0 when cached; nvcc's output)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc) to build kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    """The build's path; its hash covers the source, every shared header
    of csrc/ and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this exact build exists."""
    out = library_path(name)
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if out.exists():
            BUILD_INFO.setdefault(name, (0.0, ""))
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_INFO[name] = (time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    return out


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def build_all(names) -> None:
    """Build the named libraries at once, one nvcc process each; raises
    the first failure after all have ended."""
    errors = []

    def one(name):
        try:
            build(name)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
