#!/usr/bin/env python3
"""Time the flash-attention kernels built from several source trees, in
turns, in one process on one card.

    python3 tools/flash_kernel_ab.py OLD_CSRC NEW_CSRC [--order 0,1,1,0]

Each argument is a kernel source directory: ``paddle_tpu_torch/ops/cuda/
csrc`` of this tree or of a parent commit unpacked with ``git archive``.
Every ``flash_*.cu`` of a tree is built with the package's nvcc flags (its
headers, whatever they are, found beside it) into
``build/kernels-ab/<index>/``.  Each tree is driven through its own
wrapper module, the ``flash_attention.py`` beside its ``csrc`` (loaded as a
package of its own), so trees whose C entry points differ compare through
the same Python calls.  In the given order, each tree times (CUDA events,
L2 flushed, median of 50: ``chip_smoke.time_ms``) the dense forward, dq,
dk/dv and the whole backward (``flash_attention_bwd``) at the training
shape (B=1, H=32, S=4096, D=128, bf16, causal), where the tree takes it
the dense forward and backward at head_dim 256 (B=1, H=8, S=4096, bf16,
causal) and, where the tree has them, the varlen forward, dq, dk/dv and
backward at the packed shape (T=4096 in six documents).  dq and dk/dv are
the wrappers called alone, so where a tree has the delta pre-pass each of
them includes one.  Each line also holds the outputs' largest relative L2
distance from this tree's plain versions.

    python3 tools/flash_kernel_ab.py OLD_CSRC NEW_CSRC --kernels rpa

times the paged-attention decode kernels instead (``rpa_decode`` over
bf16 pools, ``rpa_decode_quant`` over int8 pools) at the serving shape
(B=8, H=Hkv=32, D=128, page 16, lengths 0..1024, tables 64 pages wide),
at chip_smoke.py's two further decode shapes (the served decode's own
lengths; 4 x 4096 tokens) and at the served decode's lengths over tables
256 pages wide (an engine whose longest context is 4096 tokens pads every
table so), through each tree's own ``attention.py``, with its outputs'
largest absolute distance from this tree's plain versions.  Trees that
differ in a constant of the kernel (a split's pages, say) compare so.

    python3 tools/flash_kernel_ab.py OLD_CSRC NEW_CSRC --kernels qmm

times the weight-only quantized matmuls (``qmm_i8``, ``qmm_i4``) of each
tree through its own ``quant_matmul.py``: bf16 x, group 128 (the
quantized serve's), at M=8 (a decode step) and M=256 (a prefill chunk)
over Llama-7B's four Linear shapes (chip_smoke.py's ``LLAMA7B_LINEARS``)
and at M=1 over the lm_head, each with its largest relative L2 distance
from this tree's plain version, and the sum over one decode step's 225
products at M=8.

    python3 tools/flash_kernel_ab.py OLD_CSRC NEW_CSRC --kernels update

times the optimizer's AdamW update at bench_llama's 210 parameter shapes
(chip_smoke.py's ``train_param_shapes`` at the train phase's depth, bf16
parameters, grads and moments, 4.917 B parameters on an 80 GB card): a
tree with ``fused_update.cu`` through its own ``fused_update.py`` (one
launch), a tree without it in the per-tensor form of the optimizer before
the fused kernel (a dozen elementwise passes a tensor), once with lr and
step as 0-dim device tensors (as a captured step passes them) and once as
Python floats (as the eager step did), with each tree's largest relative
L2 distance of p, m1 and m2 from the plain version's after one update.
``--kernels flash,rpa,qmm,update`` times all four.  Run it from the
repository root on a machine with a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (LLAMA7B_LINEARS, PACKED_DOCS,  # noqa: E402
                        SERVE_LENS, TRAIN_DIMS, cu_of, decode_shapes,
                        fu_tensors, nvidia_smi, quant_pools, rpa_inputs,
                        time_ms, train_layers, train_param_shapes)
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import attention as rpa_ref  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as ref  # noqa: E402
from paddle_tpu_torch.ops.cuda.quant_matmul import (  # noqa: E402
    quant_matmul_ref)
from paddle_tpu_torch.quantize.core import (  # noqa: E402
    dequantize_weight, quantize_weight)


def build(trees, sources):
    """lib<name>.so of each tree's sources (glob patterns), all nvcc
    processes started together; prints each tree's kernels that ptxas made
    spill."""
    procs, out = [], []
    for i, tree in enumerate(trees):
        dst = ROOT / "build" / "kernels-ab" / str(i)
        dst.mkdir(parents=True, exist_ok=True)
        out.append(dst)
        for src in sorted(f for pattern in sources
                          for f in Path(tree).glob(pattern)):
            procs.append((i, subprocess.Popen(
                [_build._nvcc(), *_build._NVCC_FLAGS, "-o",
                 str(dst / f"lib{src.stem}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for i, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{text}")
        kernel = None
        for line in text.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            kernel = m.group(1) if m else kernel
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) and kernel:
                print(f"tree {i}: {kernel} spills {m.group(1)} bytes")
    return out


def wrappers(index: int, tree: str, lib_dir: Path):
    """The tree's own flash_attention, attention and quant_matmul modules
    (the package above its ``ops/cuda`` loaded under a name of its own,
    without running its ``__init__``), their kernels loaded from
    lib_dir."""
    cuda_dir = Path(tree).resolve().parent
    if not (cuda_dir / "flash_attention.py").exists():
        raise FileNotFoundError(f"no flash_attention.py beside {tree}")
    name = f"_flash_ab_tree{index}"
    for mod, path in ((name, cuda_dir.parents[1]),
                      (f"{name}.ops", cuda_dir.parent),
                      (f"{name}.ops.cuda", cuda_dir)):
        pkg = types.ModuleType(mod)
        pkg.__path__ = [str(path)]
        sys.modules[mod] = pkg
    cuda = f"{name}.ops.cuda"
    fa = importlib.import_module(f"{cuda}.flash_attention")
    fa._build.load = lambda lib: ctypes.CDLL(str(lib_dir / f"lib{lib}.so"))
    fu = (importlib.import_module(f"{cuda}.fused_update")
          if (cuda_dir / "fused_update.py").exists() else None)
    return (fa, importlib.import_module(f"{cuda}.attention"),
            importlib.import_module(f"{cuda}.quant_matmul"), fu)


def decode_inputs():
    """{shape: (bf16 pools, int8 pools with their scales)} of the decode
    kernels' arguments at chip_smoke.py's shapes (H=Hkv=32, D=128, page
    16): the serving shape, the served decode's own lengths, a long
    context, and the served decode's lengths over 256-wide tables."""
    bf16 = torch.bfloat16
    shapes = [("serving shape", SERVE_LENS, 64)] + decode_shapes(32000)
    shapes.append(("served decode, tables 256 wide", shapes[1][1], 256))
    cases = {}
    for label, lens, width in shapes:
        pages = max(2048, sum(-(-n // 16) for n in lens) + 1)
        q, k, v, bt, sl = rpa_inputs(len(lens), 32, 32, 128, 16, width,
                                     pages, lens, bf16, 0)
        (kq, ks), (vq, vs) = quant_pools(k.float(), v.float())
        cases[label] = (((q, k, v, bt, sl), {}),
                        ((q, kq, vq, bt, sl), {"k_scales": ks,
                                               "v_scales": vs}))
    return cases


def time_decode(i, tree, attn, cases):
    """One line a shape: both decode kernels' times in the tree and their
    largest distance from this tree's plain version."""
    for shape, pair in cases.items():
        ms, err = {}, 0.0
        for name, (args, kw) in zip(("rpa_decode", "rpa_decode_quant"),
                                    pair):
            ms[name] = time_ms(
                lambda: attn.ragged_paged_attention_decode(*args, **kw))
            got = attn.ragged_paged_attention_decode(*args, **kw).float()
            want = rpa_ref.ragged_paged_attention_decode_ref(
                *args, None, **kw).float()
            err = max(err, (got - want).abs().max().item())
        print(f"tree {i} ({tree}) {shape}: "
              + " ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
              + f"; max abs err vs plain {err:.3e}", flush=True)


def qmm_inputs():
    """{(bits, m, k, n): (x, codes, scales, group)}: bf16 x and weights
    N(0, 0.02) quantized with group 128 on the card, at M=8 and M=256 over
    Llama-7B's Linear shapes and at M=1 over the lm_head."""
    shapes = [(m, k, n) for m in (8, 256) for (k, n) in LLAMA7B_LINEARS]
    shapes.append((1, 4096, 32000))
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for bits in (8, 4):
        weights = {}
        for m, k, n in shapes:
            if (k, n) not in weights:
                w = torch.randn(k, n, generator=g, device="cuda") * 0.02
                weights[(k, n)] = quantize_weight(w, bits=bits, group=128)
                del w
            qw, s, grp = weights[(k, n)]
            x = torch.randn(m, k, generator=g, device="cuda").to(
                torch.bfloat16)
            cases[(bits, m, k, n)] = (x, qw, s, grp)
    return cases


def time_qmm_library(cases):
    """The yardstick at each shape: one bf16 ``torch.matmul`` of x and the
    weight dequantized to bf16 beforehand (its bytes are 2x int8's)."""
    parts = []
    for (bits, m, k, n), (x, qw, s, grp) in cases.items():
        if bits != 8:
            continue
        w16 = dequantize_weight(qw, s, bits, grp, k).to(x.dtype)
        parts.append(f"M={m} {k}x{n} "
                     f"{time_ms(lambda: torch.matmul(x, w16)):.4f}")
        del w16
    print("library (bf16 torch.matmul, dequantized weight), ms: " +
          ", ".join(parts), flush=True)


def time_qmm(i, tree, qm, cases):
    """One line a bit width: each shape's time in the tree, the decode
    step's 225 products at M=8, and the largest distance from this tree's
    plain version."""
    for bits in (8, 4):
        parts, err, step = [], 0.0, 0.0
        for (b, m, k, n), (x, qw, s, grp) in cases.items():
            if b != bits:
                continue
            t = time_ms(lambda: qm.quant_matmul(x, qw, s, bits=bits,
                                                group=grp))
            if m == 8:
                step += t * LLAMA7B_LINEARS[(k, n)]
            parts.append(f"M={m} {k}x{n} {t:.4f}")
            err = max(err, rel(qm.quant_matmul(x, qw, s, bits=bits,
                                               group=grp),
                               quant_matmul_ref(x, qw, s, bits=bits,
                                                group=grp)))
        print(f"tree {i} ({tree}) qmm_i{bits} ms: " + ", ".join(parts)
              + f"; decode step (225 at M=8) {step:.3f} ms; max rel L2 vs "
              f"plain {err:.2e}", flush=True)


def per_tensor_adamw(ps, gs, m1s, m2s, lr, step, b1=0.9, b2=0.999,
                     eps=1e-8, coeff=0.01):
    """The update before the fused kernel (``AdamW._update`` with
    ``Adam._adam`` at 922d7f8): a tensor at a time, each operation a pass
    of its own, rounded in the tensors' dtype."""
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    keep = 1.0 - lr * coeff
    for p, g, m1, m2 in zip(ps, gs, m1s, m2s):
        p.mul_(keep)
        gf = g.to(m1.dtype)
        m1.mul_(b1).add_(gf, alpha=1 - b1)
        m2.mul_(b2).add_((1 - b2) * gf * gf)
        upd = lr * (m1 / bc1) / (torch.sqrt(m2 / bc2) + eps)
        p.sub_(upd.to(p.dtype))


def time_update(i, tree, fu):
    """The AdamW update at the train shapes in tree ``i``'s form, and its
    distance from the plain version after one update from the same
    state."""
    from paddle_tpu_torch.ops.cuda import fused_update as fu_ref
    layers = train_layers(torch.cuda.get_device_properties(0).total_memory,
                          *TRAIN_DIMS[:2], TRAIN_DIMS[4])
    shapes = train_param_shapes(layers)
    ((ps, gs, m1s, m2s),) = fu_tensors(shapes, torch.bfloat16,
                                       torch.bfloat16, 91, copies=1)
    n = sum(p.numel() for p in ps)
    lr_t = torch.tensor(1e-6, device="cuda")
    st_t = torch.tensor(3.0, device="cuda")
    flags = [True] * len(ps)
    # one update against the plain version's from the same state, held on
    # the embedding, the first layer's norm and q, and the lm_head (a copy
    # of every tensor would not fit beside them)
    idx = [0, 1, 2, len(ps) - 1]
    saved = [(ps[j].clone(), m1s[j].clone(), m2s[j].clone()) for j in idx]
    if fu is not None:
        fu.fused_update(fu.ADAM, ps, gs, m1s, m2s, flags, lr_t, st_t,
                        coeff=0.01)
    else:
        per_tensor_adamw(ps, gs, m1s, m2s, lr_t, st_t)
    err = 0.0
    for j, (p0, a0, b0) in zip(idx, saved):
        fu_ref.fused_update_ref(fu_ref.ADAM, [p0], [gs[j]], [a0], [b0],
                                [True], lr_t, st_t, coeff=0.01)
        err = max(err, rel(ps[j], p0), rel(m1s[j], a0), rel(m2s[j], b0))
    del saved
    if fu is not None:
        cache = {}
        forms = {"fused kernel": lambda: fu.fused_update(
            fu.ADAM, ps, gs, m1s, m2s, flags, lr_t, st_t, coeff=0.01,
            cache=cache)}
    else:
        forms = {"per-tensor passes, device scalars":
                 lambda: per_tensor_adamw(ps, gs, m1s, m2s, lr_t, st_t),
                 "per-tensor passes, Python floats":
                 lambda: per_tensor_adamw(ps, gs, m1s, m2s, 1e-6, 3)}
    parts = [f"{k} {time_ms(fn, iters=5, warmup=1):.3f} ms"
             for k, fn in forms.items()]
    print(f"tree {i} ({tree}) AdamW update, {len(ps)} tensors "
          f"({n / 1e9:.3f} B bf16): " + ", ".join(parts)
          + f"; bound {n * 14 / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s; max rel "
          f"L2 vs plain after one update (4 tensors) {err:.2e}", flush=True)
    del ps, gs, m1s, m2s
    torch.cuda.empty_cache()


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree indices (default: 0..n-1 "
                         "then n-1..0)")
    ap.add_argument("--kernels", default="flash",
                    help="comma-separated: flash, rpa, qmm, update "
                         "(default flash)")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("flash_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    n = len(args.trees)
    order = ([int(x) for x in args.order.split(",")] if args.order
             else list(range(n)) + list(reversed(range(n))))
    t0 = time.perf_counter()
    libs = build(args.trees, (["flash_*.cu"] if "flash" in kinds else [])
                 + (["rpa_decode.cu"] if "rpa" in kinds else [])
                 + (["quant_matmul.cu"] if "qmm" in kinds else [])
                 + (["fused_update.cu"] if "update" in kinds else []))
    mods = [wrappers(i, t, d) for i, (t, d) in enumerate(zip(args.trees,
                                                             libs))]
    print(f"built {n} trees in {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    if "rpa" in kinds:
        cases = decode_inputs()
        for i in order:
            time_decode(i, args.trees[i], mods[i][1], cases)
    if "qmm" in kinds:
        cases = qmm_inputs()
        time_qmm_library(cases)
        for i in order:
            time_qmm(i, args.trees[i], mods[i][2], cases)
        del cases
    if "update" in kinds:
        for i in order:
            time_update(i, args.trees[i], mods[i][3])
    if "flash" not in kinds:
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, 32, 4096, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = ref.flash_attention_fwd_ref(q, k, v, True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    cu = cu_of(PACKED_DOCS)
    pq, pk, pv, pdo = (x[0] for x in (q, k, v, do))
    pout, plse = ref.varlen_flash_fwd_ref(pq, pk, pv, cu, True)
    pwant = ref.varlen_flash_bwd_ref(pq, pk, pv, cu, pout, plse, pdo, True)
    wq, wk, wv, wdo = (torch.randn(1, 8, 4096, 256, generator=g,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
    wout, wlse = ref.flash_attention_fwd_ref(wq, wk, wv, True)
    wwant = ref.flash_attention_bwd_ref(wq, wk, wv, wout, wlse, wdo, True)
    for i in order:
        fa = mods[i][0]
        ms = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd(
                  q, k, v, True)),
              "flash_dq": time_ms(lambda: fa.flash_attention_dq(
                  q, k, v, out, lse, do, True)),
              "flash_dkv": time_ms(lambda: fa.flash_attention_dkv(
                  q, k, v, out, lse, do, True)),
              "flash_bwd": time_ms(lambda: fa.flash_attention_bwd(
                  q, k, v, out, lse, do, True))}
        err = max([rel(fa.flash_attention_fwd(q, k, v, True)[0], out)]
                  + [rel(a, b) for a, b in zip(fa.flash_attention_bwd(
                      q, k, v, out, lse, do, True), want)])
        if fa.MAX_HEAD_DIM >= 256:
            ms.update({
                "d256_fwd": time_ms(lambda: fa.flash_attention_fwd(
                    wq, wk, wv, True)),
                "d256_bwd": time_ms(lambda: fa.flash_attention_bwd(
                    wq, wk, wv, wout, wlse, wdo, True))})
            err = max([err, rel(fa.flash_attention_fwd(wq, wk, wv,
                                                       True)[0], wout)]
                      + [rel(a, b) for a, b in zip(fa.flash_attention_bwd(
                          wq, wk, wv, wout, wlse, wdo, True), wwant)])
        if hasattr(fa, "varlen_flash_bwd"):
            ms.update({
                "varlen_fwd": time_ms(lambda: fa.varlen_flash_fwd(
                    pq, pk, pv, cu, True)),
                "varlen_dq": time_ms(lambda: fa.varlen_flash_dq(
                    pq, pk, pv, cu, pout, plse, pdo, True)),
                "varlen_dkv": time_ms(lambda: fa.varlen_flash_dkv(
                    pq, pk, pv, cu, pout, plse, pdo, True)),
                "varlen_bwd": time_ms(lambda: fa.varlen_flash_bwd(
                    pq, pk, pv, cu, pout, plse, pdo, True))})
            err = max([err, rel(fa.varlen_flash_fwd(pq, pk, pv, cu,
                                                    True)[0], pout)]
                      + [rel(a, b) for a, b in zip(fa.varlen_flash_bwd(
                          pq, pk, pv, cu, pout, plse, pdo, True), pwant)])
        print(f"tree {i} ({args.trees[i]}): " + " ".join(
            f"{name} {t:.4f} ms" for name, t in ms.items())
            + f"; max rel L2 vs plain {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
