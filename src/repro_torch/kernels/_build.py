"""Build and load the port's CUDA kernels.

All sources under ``kernels/csrc`` are compiled by ONE ``nvcc`` invocation
(``-gencode arch=compute_90a,code=sm_90a -O3``, IEEE division and ``expf``:
no ``--use_fast_math``) into a shared library with a plain C interface,
loaded with ``ctypes``.  The two decode kernels share their attention code
(``paged_attn_common.cuh``) and these flags, which is what makes the fused
kernel's output bit-identical to the unfused one's on the card.

The library is built at first use, from the checkout's sources only, into
``build/repro_torch_kernels/`` at the repository root (``build/`` is
git-ignored); its file name carries a hash of the sources and flags, so an
edited source is rebuilt.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_attn.cu", "policy_attn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: ctypes signature of every C entry point: (argtypes, restype)
SIGNATURES = {
    "repro_paged_attention": (
        [_int] + [_vp] * 7 + [_int] * 6 + [_float, _vp], _int),
    "repro_policy_paged_attention": (
        [_int] + [_vp] * 5 + [_int] + [_vp] * 13 + [_int] * 6
        + [_float, _int, _vp], _int),
    "repro_error_string": ([_int], ctypes.c_char_p),
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc / ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels (once per source hash); returns the library path,
    the seconds nvcc took and its log.  Raises with nvcc's output on
    failure."""
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


_LIB = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
