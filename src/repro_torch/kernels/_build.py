"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc`` is compiled by its own ``nvcc -c``
(kernel 5's twice, ``UNITS``; all started together, ``-gencode
arch=compute_90a,code=sm_90a -O3``, IEEE division and ``expf``: no
``--use_fast_math``), and one more ``nvcc`` links
the objects into a shared library with a plain C interface, loaded with
``ctypes``.  The three decode kernels share their page math
(``paged_attn_common.cuh``) and these flags, which is what makes the fused
kernels' output bit-identical to the unfused one's on the card.

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
from typing import List, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_attn.cu", "policy_attn.cu", "adaptive_attn.cu", "awrp_select.cu",
           "flash_attn.cu", "flash_attn_bwd.cu", "sweep.cu")
#: the translation units, (source, its own nvcc flags): every source once,
#: and kernel 5's a second time for its bfloat16 kernels, which alone would
#: be the build's longest compile
UNITS = (*((src, ()) for src in SOURCES),
         ("adaptive_attn.cu", ("-DREPRO_ADAPTIVE_BF16",)))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: ctypes signature of every C entry point: (argtypes, restype)
SIGNATURES = {
    "repro_paged_attention": (
        [_int] + [_vp] * 9 + [_int] * 6 + [_float, _vp], _int),
    "repro_policy_paged_attention": (
        [_int] + [_vp] * 21 + [_int] * 6 + [_float, _int, _vp], _int),
    "repro_adaptive_policy_paged_attention": (
        [_int] + [_vp] * 33 + [_int] * 7 + [_float, _int, _int, _vp], _int),
    "repro_awrp_select": ([_vp] * 6 + [_int] * 2 + [_vp], _int),
    "repro_awrp_select_rows": ([_vp] * 5 + [_int] * 2 + [_vp], _int),
    "repro_flash_attention": ([_int] + [_vp] * 5 + [_int] * 9 + [_float, _vp], _int),
    "repro_flash_attention_bwd": ([_int] + [_vp] * 10 + [_int] * 9 + [_float, _vp], _int),
    "repro_flat_sweep": ([_vp] * 9 + [_int] * 4 + [_vp], _int),
    "repro_adaptive_sweep": ([_vp] * 10 + [_int] * 7 + [_vp], _int),
    "repro_flat_stream": ([_vp] * 14 + [_int] * 3 + [_float] + [_vp] * 4 + [_int], _int),
    "repro_adaptive_stream": ([_vp] * 17 + [_int] * 6 + [_float] + [_vp] * 4 + [_int], _int),
    "repro_error_string": ([_int], ctypes.c_char_p),
}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc / ptxas output (registers, shared memory, spills)


#: every build this process ran nvcc for (``obs/profiling.py`` reports their
#: count and seconds as ``compile/nvcc/...``)
BUILDS: List[BuildInfo] = []


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(UNITS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels (once per source hash): one ``nvcc -c`` per
    translation unit (``UNITS``), run in parallel, then one link.  Returns
    the library path, the seconds the build took and nvcc's log.  Raises with nvcc's output on
    failure."""
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for i, (src, flags) in enumerate(UNITS):
        obj = BUILD_DIR / f"{tag}.{i}.{Path(src).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(CSRC / src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            for _, _, other in jobs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    for _, obj, _ in jobs:
        obj.unlink()
    info = BuildInfo(out, time.perf_counter() - t0, log)
    BUILDS.append(info)
    return info


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
