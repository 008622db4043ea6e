"""Kernel 6's bf16 forward (``csrc/flash_attn.cu``) of this checkout against
the same kernel of another checkout, timed in turns on one card.

    python tools/flash_turns.py [--parent DIR ...] [--labels a,b,...] [--out FILE]

For each bf16 row of ``chip_smoke.FLASH_CASES`` (or the rows named by
``--labels``): this checkout's kernel against the plain version (one bf16
ulp, ``chip_smoke.flash_gate``), ``out`` equal with ``lse`` on and off and
over 6 repeated launches; then its time (``chip_smoke.time_ms``) beside the
bound and one ``scaled_dot_product_attention`` call over the same mask.
With ``--parent`` (a checkout of another commit, e.g. one unpacked with
``git archive``; may be given more than once), that checkout's library is
built by its own ``_build.build()`` in a subprocess and its C entry point
``repro_flash_attention`` is called on the same tensors: timed in turns,
each parent, then this checkout twice, then each parent again in reverse
order, and held to the plain version too.  Also prints, per bf16 function
of this checkout's library and of each parent's, its instruction counts
from ``cuobjdump -sass`` (HGMMA, UTMALDG, HMMA, WARPGROUP.ARRIVE /
DEPBAR, LDL / STL, CALL) and, for this checkout, ptxas's lines for it
(registers, spills).  One JSON
line per row, each also appended to ``--out``, then a summary line.  Needs
one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def parent_library(parent: Path):
    """Build ``parent``'s kernel library with its own ``_build.build()``, load it, and
    return its ``repro_flash_attention`` and the library's path."""
    parent = parent.resolve()
    code = "from repro_torch.kernels import _build; print(_build.build().path)"
    env = dict(os.environ, PYTHONPATH=str(parent / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent, env=env,
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {parent} failed:\n{proc.stdout}\n{proc.stderr}")
    path = proc.stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(path)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.repro_flash_attention
    fn.argtypes = [i] + [vp] * 5 + [i] * 9 + [f, vp]
    fn.restype = i
    return fn, Path(path)


def main() -> int:
    """Parse the arguments, build, check and time; 0, or 1 without a card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, action="append", default=[])
    ap.add_argument("--labels", default="")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attn import flash_attention_kernel
    from repro_torch.kernels.paged_attn import DTYPE_CODE

    if not torch.cuda.is_available():
        print("flash_turns: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")

    def sass(lib: Path) -> dict:
        return {op: cs.sass_count(lib, "flash_attention_bf16_kernel", op)
                for op in ("HGMMA", "UTMALDG", "HMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE",
                           "LDL", "STL", "CALL")}

    def ptxas_lines(log: str, name: str) -> list:
        out, on = [], False
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                on = name in ln
            if on:
                out.append(ln.strip())
        return out

    info = _build.build()
    emit({"build_s": info.seconds, "card": cs.smi(),
          "sass": sass(info.path),
          "ptxas": cs.ptxas_usage(info.log, "flash_attention_bf16_kernel"),
          "ptxas_lines": ptxas_lines(info.log, "flash_attention_bf16_kernel"),
          "warnings": [ln for ln in info.log.splitlines() if "warning" in ln.lower()]})
    parents = []
    for p in args.parent:
        fn, path = parent_library(p)
        parents.append(fn)
        emit({"parent": str(p), "sass": sass(path)})
    want = set(filter(None, args.labels.split(",")))
    worst = 0.0
    for label, shape, skv, causal, window, kv_len, dtype in cs.FLASH_CASES:
        if dtype != torch.bfloat16 or (want and label not in want):
            continue
        B, S, KVH, G, hd = shape
        Skv = S if skv is None else skv
        kl = Skv if kv_len is None else kv_len
        kw = {"causal": causal, "window": window, "kv_len": kl}
        q, k, v = cs.flash_inputs(label, shape, Skv, dtype, dev)
        out = flash_attention_kernel(q, k, v, **kw)
        out_lse, lse = flash_attention_kernel(q, k, v, **kw, return_lse=True)
        plain, plain_lse = ref.flash_attention_plain(q, k, v, **kw, return_lse=True)
        torch.cuda.synchronize()
        row = {"label": label, "shape": list(shape), "kv_seq": Skv, "causal": causal,
               "window": window, "kv_len": kl,
               "out_equal_lse_on_off": bool(torch.equal(out, out_lse)),
               "lse_err_over_tol": cs.excess(lse, plain_lse, cs.LSE_RTOL, cs.LSE_ATOL)}
        err = (out.float() - plain.float()).abs().max().item()
        row["max_abs_err"] = err
        row["err_over_tol"] = cs.excess(out, plain, cs.OUT_RTOL, cs.OUT_ATOL)
        row["finite"] = bool(torch.isfinite(out.float()).all())
        row["repeat_equal"] = all(torch.equal(out, flash_attention_kernel(q, k, v, **kw))
                                  for _ in range(5))
        pairs = cs.attended_pairs(S, Skv, causal, window, kl)
        flops = 4 * hd * pairs * B * KVH * G
        nbytes = (2 * q.numel() + (k.numel() + v.numel()) * kl // Skv) * q.element_size()
        t_bytes, t_ops = nbytes / cs.HBM_BYTES_PER_S * 1e3, flops / cs.BF16_FLOPS * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        mine = lambda: flash_attention_kernel(q, k, v, **kw)  # noqa: E731
        if parents:
            pout = torch.empty_like(q)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def theirs(fn):
                def call():
                    err_ = fn(DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              pout.data_ptr(), 0, B, S, Skv, KVH, G, hd, int(causal),
                              int(window), kl, ref.attn_scale(hd), stream)
                    if err_:
                        raise RuntimeError(f"repro_flash_attention: CUDA error {err_}")
                return call

            calls = [theirs(fn) for fn in parents]
            row["parent_err_over_tol"] = []
            for call in calls:
                call()
                torch.cuda.synchronize()
                row["parent_err_over_tol"].append(
                    cs.excess(pout, plain, cs.OUT_RTOL, cs.OUT_ATOL))
            order = [*calls, mine, mine, *calls[::-1]]
            turns = [cs.time_ms(f) for f in order]
            n = len(calls)
            row["ms"] = turns[n:n + 2]
            row["parent_ms"] = [[turns[i], turns[-1 - i]] for i in range(n)]
        else:
            row["ms"] = [cs.time_ms(mine)]
        row["library_ms"] = cs.sdpa_flash_ms(q, k, v, causal, window, kl)
        row["achieved_tflops"] = flops / min(row["ms"]) / 1e9
        worst = max(worst, row["err_over_tol"])
        emit(row)
        del q, k, v, out, out_lse, lse, plain, plain_lse
        torch.cuda.empty_cache()
    emit({"worst_err_over_tol": worst, "card": cs.smi()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
