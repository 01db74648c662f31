#!/usr/bin/env python3
"""Time the flash-attention kernels built from several source trees, in
turns, in one process on one card.

    python3 tools/flash_kernel_ab.py OLD_CSRC NEW_CSRC [--order 0,1,1,0]

Each argument is a directory holding ``flash_fwd.cu``, ``flash_bwd.cu`` and
``flash_common.cuh`` (e.g. ``paddle_tpu_torch/ops/cuda/csrc`` of this tree
and of a parent commit unpacked with ``git archive``).  Every tree is built
with the package's nvcc flags into ``build/kernels-ab/<index>/``; then, in
the given order, the package's wrappers are pointed at that tree's
libraries and time (``chip_smoke.time_ms``: CUDA events, L2 flushed, median
of 50) the dense forward, dq and dk/dv kernels at the training shape (B=1,
H=32, S=4096, D=128, bf16, causal) and, where the tree has them, the varlen
kernels at the packed shape (T=4096 in six documents).  Each line also
holds the kernels' relative L2 distance from their plain versions.  Run it
from the repository root on a machine with a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import PACKED_DOCS, cu_of, nvidia_smi, time_ms  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402


def build(trees):
    """lib<name>.so of each tree, all nvcc processes started together."""
    procs, out = [], []
    for i, tree in enumerate(trees):
        dst = ROOT / "build" / "kernels-ab" / str(i)
        dst.mkdir(parents=True, exist_ok=True)
        out.append(dst)
        for name in ("flash_fwd", "flash_bwd"):
            procs.append(subprocess.Popen(
                [_build._nvcc(), *_build._NVCC_FLAGS, "-o",
                 str(dst / f"lib{name}.so"), str(Path(tree) / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{text}")
    return out


ENTRIES = dict(fa._ENTRIES)


def use(lib_dir: Path) -> bool:
    """Point the wrappers at the libraries in lib_dir; returns whether the
    tree has the varlen entry points."""
    has_varlen = hasattr(ctypes.CDLL(str(lib_dir / "libflash_fwd.so")),
                         "varlen_fwd")
    fa._LIBS.clear()
    fa._ENTRIES.clear()
    fa._ENTRIES.update({k: e for k, e in ENTRIES.items()
                        if has_varlen or k.startswith("flash_")})
    fa._build.load = lambda name: ctypes.CDLL(str(lib_dir / f"lib{name}.so"))
    return has_varlen


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree indices (default: 0..n-1 "
                         "then n-1..0)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    n = len(args.trees)
    order = ([int(x) for x in args.order.split(",")] if args.order
             else list(range(n)) + list(reversed(range(n))))
    t0 = time.perf_counter()
    libs = build(args.trees)
    print(f"built {n} trees in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, 32, 4096, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd_ref(q, k, v, True)
    rq = fa.flash_attention_dq_ref(q, k, v, out, lse, do, True)
    cu = cu_of(PACKED_DOCS)
    pq, pk, pv, pdo = (x[0] for x in (q, k, v, do))
    pout, plse = fa.varlen_flash_fwd_ref(pq, pk, pv, cu, True)
    pdq = fa.varlen_flash_dq_ref(pq, pk, pv, cu, pout, plse, pdo, True)
    for i in order:
        varlen = use(libs[i])
        ms = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd(
                  q, k, v, True)),
              "flash_dq": time_ms(lambda: fa.flash_attention_dq(
                  q, k, v, out, lse, do, True)),
              "flash_dkv": time_ms(lambda: fa.flash_attention_dkv(
                  q, k, v, out, lse, do, True))}
        err = max(rel(fa.flash_attention_fwd(q, k, v, True)[0], out),
                  rel(fa.flash_attention_dq(q, k, v, out, lse, do, True),
                      rq))
        if varlen:
            ms.update({
                "varlen_fwd": time_ms(lambda: fa.varlen_flash_fwd(
                    pq, pk, pv, cu, True)),
                "varlen_dq": time_ms(lambda: fa.varlen_flash_dq(
                    pq, pk, pv, cu, pout, plse, pdo, True)),
                "varlen_dkv": time_ms(lambda: fa.varlen_flash_dkv(
                    pq, pk, pv, cu, pout, plse, pdo, True))})
            err = max(err, rel(fa.varlen_flash_fwd(pq, pk, pv, cu,
                                                   True)[0], pout),
                      rel(fa.varlen_flash_dq(pq, pk, pv, cu, pout, plse,
                                             pdo, True), pdq))
        print(f"tree {i} ({args.trees[i]}): " + " ".join(
            f"{name} {t:.4f} ms" for name, t in ms.items())
            + f"; max rel L2 vs plain {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
