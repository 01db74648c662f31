#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device — the card's name, count, and ``nvidia-smi`` name/power limit;
2. build  — nvcc compiles every kernel source of the package (sm_90a), one
   process per source, all started together, and reports ptxas's
   registers and spills of each kernel (none may spill in a wgmma kernel,
   a head_dim-256 instantiation, a decode kernel or a tensor-core
   quantized matmul), the wgmma (HGMMA) and TMA-load (UTMALDG)
   instructions of the flash forward's and backward's libraries and the
   mma.sync (HMMA), wgmma and TMA-load instructions of the quantized
   matmul's;
3. kernel — each kernel against its plain PyTorch version on the same
   inputs at the main paths' shapes, plus edge cases (head_dim up to 256);
   kernel, plain and library times with CUDA events (L2 flushed between
   launches) and the card's bound for the same work (the ragged flash
   forward, which no path calls, at the serving chunk shape; the flash
   kernels also at head_dim 256; the decode kernels also at the served
   decode's own lengths and at a long context; the quantized matmuls at
   M=8 and M=256 over every Llama-7B Linear, on both routes); the attention
   functionals at head_dim 136, 192, 256 and 272 on the card against the
   same calls on the CPU (the kernels' plain versions), with their routes;
4. serve  — Llama-7B at full width and depth (random weights from a seed,
   bf16) behind ``ServingEngine``: 10 greedy requests, launch counts read
   around the run, first-decode-step logits held against an engine on the
   plain gather path, and a tiny f32 model's tokens held against a
   full-recompute greedy reference;
5. train  — Llama-7B width (hidden 4096, intermediate 11008, 32 heads,
   seq 4096, bf16; the layer count by bench.py's memory rule) trained
   eagerly with AdamW, bench_llama's optimizer and data: one warm-up and
   three timed steps on one batch, launch counts read around them, losses
   finite and falling;
6. packed attention — ``flash_attn_unpadded`` forward and backward at
   Llama-7B's attention width (32 heads x 128) for each of 32 layers on
   seeded q/k/v, T = 4096 tokens in six documents, causal, bf16: launch
   counts read around the run, outputs and gradients finite, each
   document's equal to dense ``flash_sdpa`` on that document alone;
7. train parity — a tiny f32 Llama takes three AdamW steps on the card
   (through the kernels) and on the CPU (through their plain versions)
   in this process; losses and parameters must agree;
8. quantized serve — Llama-7B at full width and depth quantized on the
   card by ``quantize_for_inference``: (a) int8 weights with the int8 KV
   pool, (b) int4 weights with the bf16 pool, each serving phase 4's
   traffic with launch counts read around the run, the report's SNR
   checked, and first-decode-step logits held against the same quantized
   model on the plain paths (and printed against the bf16 model's); then
   a tiny f32 Llama with int8 weights and int8 KV on the card vs the CPU;
9. profiles — torch.profiler breakdowns of 256-token prefill chunks and
   batch-8 decode steps (bf16; int8 weights and KV; int4 weights) and of
   one train step,
   after every timed phase, since a profiler run slows the host side of
   later work.

The second-to-last stdout line is ``{"kernels": [...]}`` (each row's
``launches`` counted on the path named by its ``launches_in``); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# time_ms's device spin before each timed call: about 1 ms at the H100's
# 1.98 GHz boost clock
SPIN_CYCLES = 2_000_000
# Tolerances of kernel vs plain version (same inputs, both f32 inside):
# float32 differs only by summation order (~1e-6 at these lengths);
# float16/bfloat16 outputs are rounded once from f32, so two f32 results a
# few f32 ulps apart can land one output ulp apart — 2^-10 and 2^-7
# relative.  Bounds: |kernel - plain| <= atol + rtol * |plain|.
TOL = {torch.float32: (1e-5, 1e-5), torch.float16: (2e-3, 2e-3),
       torch.bfloat16: (1e-2, 1e-2)}
# Serving-path logits of the kernel engine vs the gather-path engine: the
# gather path rounds scores and probabilities to bf16 where the kernel
# keeps f32, and 32 layers carry the difference to the logits.  Bound on
# ||a - b|| / ||b|| over the compared rows.
LOGITS_REL_TOL = 0.05
# Flash kernels vs plain versions.  float32: elementwise atol/rtol 1e-5 at
# the small shapes checked (both sum in f32, in another order).  16-bit
# inputs: the kernels round each probability tile to the input type
# against a running row max and the plain version against the final one,
# so single probabilities may sit one ulp apart, and dq/dk/dv sum such
# products over up to 4096 keys or queries: elementwise bounds are too
# tight, so the bound is ||kernel - plain|| <= tol ||plain|| over the
# tensor, plus an RMS floor of 1e-5 a element for gradients that vanish
# (at S=1, dq = dk = 0 exactly and both sides hold rounding noise of
# ~1e-6).  lse is f32 in both: 1e-5 relative.
FLASH_REL_TOL = {torch.float16: 2e-3, torch.bfloat16: 1e-2}
FLASH_RMS_FLOOR = 1e-5
# Train parity, tiny f32 Llama on the card vs the CPU (f32 matmuls on the
# card in full f32: TF32 is off): the loss within 1e-4 relative at every
# step; after 3 AdamW steps every parameter within 1e-4 relative L2.
PARITY_LOSS_RTOL = 1e-4
PARITY_PARAM_RTOL = 1e-4
# Peak device-memory bandwidth (bytes/s) and dense rates (ops/s) by card,
# NVIDIA data sheets (SXM parts unless named).
PEAK_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
           ("H100", 3.35e12))
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
# Quantized matmul kernels vs plain version (same x, codes and scales, both
# with f32 products and sums, in another order): float32 outputs within
# ||kernel - plain|| <= 1e-5 ||plain||; float16/bfloat16 outputs are
# rounded once from f32 (at most half an ulp, 2^-9 relative in bf16), so
# 4e-3 ||plain||.
QMM_REL_TOL = {torch.float32: 1e-5, torch.float16: 4e-3,
               torch.bfloat16: 4e-3}
# Llama-7B's Linear shapes (K, N) with their launches a step: q/k/v/o 4 x
# 32 layers, gate/up 2 x 32, down 32, and the lm_head once (last rows only)
LLAMA7B_LINEARS = {(4096, 4096): 128, (4096, 11008): 64, (11008, 4096): 32,
                   (4096, 32000): 1}
QMM_LAUNCHES_A_STEP = sum(LLAMA7B_LINEARS.values())          # 225
# Tiny f32 model with int8 weights and KV, card vs CPU: first-decode logits
# within 1e-4 relative L2 (f32 on both sides, sums in another order)
QUANT_PARITY_RTOL = 1e-4


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def peak_bw(name: str):
    for key, bw in PEAK_BW:
        if key in name:
            return bw, key
    return 3.35e12, "H100 SXM (card not recognised; assumed)"


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of one call: CUDA events around each call, a
    384 MB write between calls so every call finds the 50 MB L2 cold, then
    a device spin of about 1 ms (``torch.cuda._sleep``), during which the
    host enqueues the call's launches: its argument checks, small index
    ops (e.g. the varlen span) and ctypes calls then fall outside the
    timed window.  (Without the spin, a varlen wrapper's host work
    outlasted the write and its idle gaps were timed as kernel time.)"""
    flush = torch.empty(384 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# -- phase 2: the build's report ------------------------------------------

def build_report(lib: str, info: dict) -> None:
    """ptxas's registers and spill bytes of each kernel of a library (it
    raises where a warp-specialised kernel, a head_dim-256 instantiation or
    a decode kernel spills) and ptxas's warnings that it serialised wgmma;
    for libflash_fwd and libflash_bwd also the wgmma (HGMMA) and TMA-load
    (UTMALDG) instructions in their SASS, which show that their 16-bit
    kernels at D 64/128 (the forward's at 256 too) are the
    warp-specialised ones."""
    from paddle_tpu_torch.ops.cuda import _build
    tools = Path(_build._nvcc()).parent
    kernel, rows = None, {}
    for line in info["ptxas"].splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            rows.setdefault(kernel, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.setdefault(kernel, {})["regs"] = int(m.group(1))
    mangled = sorted(rows)
    names = subprocess.run([str(tools / "cu++filt")],
                           input="\n".join(mangled), capture_output=True,
                           text=True, timeout=60, check=True).stdout
    names = names.splitlines()
    must_not_spill = []
    for kernel, name in zip(mangled, names):
        r = rows[kernel]
        log(f"  {lib}: {name}: {r.get('regs')} registers, "
            f"{r.get('spill', 0)} bytes spill stores")
        # the wgmma kernels, the mma.sync kernels' head_dim-256 ones, every
        # decode kernel and the quantized matmul's tensor-core kernels
        if ("_ws_" in kernel or re.search(r", 256>", name)
                or lib == "rpa_decode" or "qmm_tc_kernel" in kernel
                or "qmm_wg_kernel" in kernel):
            must_not_spill.append((name, r.get("spill", 0)))
    for line in info["ptxas"].splitlines():
        if "Performance Loss" in line or "serialized" in line:
            log(f"  {lib}: ptxas: {line.strip()}")
    if lib in ("rpa_decode", "quant_matmul") and any(
            n for _, n in must_not_spill):
        raise AssertionError(f"lib{lib}: kernels spill: " + "; ".join(
            f"{n} {b} bytes" for n, b in must_not_spill if b))
    if lib == "quant_matmul":
        sass = subprocess.run([str(tools / "cuobjdump"), "-sass",
                               info["path"]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts = {op: len(re.findall(op, sass))
                  for op in ("HMMA", "HGMMA", "UTMALDG")}
        log(f"  libquant_matmul: {len(must_not_spill)} tensor-core "
            f"instantiations, 0 bytes spilled; SASS holds {counts['HMMA']} "
            f"HMMA (mma.sync), {counts['HGMMA']} HGMMA (wgmma) and "
            f"{counts['UTMALDG']} UTMALDG (TMA tile load) instructions")
        if not must_not_spill or not all(counts.values()):
            raise AssertionError("libquant_matmul lacks its tensor-core or "
                                 "TMA kernels")
    if lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([str(tools / "cuobjdump"), "-sass",
                               info["path"]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts = {op: len(re.findall(op, sass)) for op in ("HGMMA", "UTMALDG")}
        spills = sum(n for _, n in must_not_spill)
        log(f"  {lib}: SASS holds {counts['HGMMA']} HGMMA (wgmma) and "
            f"{counts['UTMALDG']} UTMALDG (TMA tile load) instructions; the "
            f"wgmma and head_dim-256 kernels spill {spills} bytes")
        if not counts["HGMMA"] or not counts["UTMALDG"]:
            raise AssertionError(f"lib{lib} has no wgmma or no TMA load")
        if spills:
            raise AssertionError(f"lib{lib}: kernels spill: " + "; ".join(
                f"{n} {b} bytes" for n, b in must_not_spill if b))


# -- phase 3: kernels vs plain ----------------------------------------------

def rpa_inputs(batch, heads, kv_heads, d, page, max_pages, num_pages, lens,
               dtype, seed):
    """Random q and pools; each sequence owns distinct random pages (never
    page 0), its table tail padded with page 0, which holds large garbage
    a correct kernel never reads."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(batch, heads, d, generator=g, device="cuda").to(dtype)
    shape = (num_pages, page, kv_heads, d)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k[0] = 300.0
    v[0] = -300.0
    rng = np.random.default_rng(seed)
    bt = np.zeros((batch, max_pages), np.int32)
    for b, n in enumerate(lens):
        owned = math.ceil(n / page)
        bt[b, :owned] = rng.choice(np.arange(1, num_pages), owned,
                                   replace=False)
    return (q, k, v, torch.from_numpy(bt).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


# the serving shape's decode lengths: an inert row, length 1, lengths at
# and past a page boundary, a full table of 64 pages
SERVE_LENS = [0, 1, 16, 17, 127, 300, 640, 1024]


def quant_pools(k, v):
    """int8 codes and f32 scales of f32 pools (quantize_kv_rows), page 0
    filled with garbage codes and scales a correct kernel never reads:
    ((k codes, k scales), (v codes, v scales))."""
    from paddle_tpu_torch.quantize.core import quantize_kv_rows
    (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    kq[0], vq[0], ks[0], vs[0] = 127, -127, 300.0, 300.0
    return (kq, ks), (vq, vs)


def rpa_bound_ms(q, k, lens, page, bw, scaled=False):
    """Least time for the work these inputs need: every K/V row of the
    valid tokens (with its f32 scale, for int8 pools), q, the output and
    the used table entries moved once, or the QK and PV multiply-adds at
    q's type's dense peak."""
    b, h, d = q.shape
    hkv, el = k.shape[2], k.element_size()
    tokens = int(sum(lens))
    nbytes = (2 * tokens * hkv * (d * el + 4 * scaled)
              + 2 * b * h * d * q.element_size()
              + 4 * (b + sum(math.ceil(n / page) for n in lens)))
    ops = 4 * tokens * h * d
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rpa_case(label, batch, heads, kv_heads, d, page, max_pages, num_pages,
             lens, dtype, seed):
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode, ragged_paged_attention_decode_ref)
    q, k, v, bt, sl = rpa_inputs(batch, heads, kv_heads, d, page, max_pages,
                                 num_pages, lens, dtype, seed)
    got = ragged_paged_attention_decode(q, k, v, bt, sl)
    want = ragged_paged_attention_decode_ref(q, k, v, bt, sl)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[dtype]
    bad = err > atol + rtol * want.float().abs()
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    log(f"  {label}: B={batch} H={heads} Hkv={kv_heads} D={d} page={page} "
        f"{str(dtype).replace('torch.', '')} lens={list(lens)} "
        f"max_abs_err={err.max().item():.3e} (atol {atol:g}, rtol {rtol:g})")
    if bool(bad.any()) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version on {int(bad.sum())} elements")
    if zero_rows and bool(got[zero_rows].ne(0).any()):
        raise AssertionError(f"{label}: inert rows (len 0) are not zero")
    return q, k, v, bt, sl, err.max().item()


def phase_kernel(card, bw):
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode, ragged_paged_attention_decode_ref)
    bf16 = torch.bfloat16
    # the serving phase's decode shape: B=8, H=Hkv=32, D=128, page 16,
    # 2048 pages, tables 64 wide (max_seq_len 1024), SERVE_LENS
    main = rpa_case("serving shape, MHA", 8, 32, 32, 128, 16, 64, 2048,
                    SERVE_LENS, bf16, SEED)
    rpa_case("GQA 32q/8kv", 8, 32, 8, 128, 16, 64, 2048, SERVE_LENS, bf16,
             SEED + 1)
    rpa_case("float32", 8, 32, 32, 128, 16, 64, 512,
             [0, 1, 15, 16, 33, 200, 511, 1000], torch.float32, SEED + 2)
    rpa_case("edge: page boundary and length 1", 4, 32, 32, 128, 16, 8, 64,
             [16, 1, 32, 128], bf16, SEED + 3)
    rpa_case("edge: odd page size, D=100, fp16, GQA 12q/4kv", 5, 12, 4, 100,
             7, 20, 200, [0, 1, 7, 8, 140], torch.float16, SEED + 4)
    q, k, v, bt, sl, err = main
    b, h, d = q.shape
    t = bt.shape[1] * k.shape[1]
    ms = time_ms(lambda: ragged_paged_attention_decode(q, k, v, bt, sl))
    plain_ms = time_ms(lambda: ragged_paged_attention_decode_ref(
        q, k, v, bt, sl))
    # library yardstick: SDPA over K/V already gathered into a dense
    # (B, H, T, D) layout with a key mask; the gather is NOT timed
    kd = k[bt.long()].reshape(b, t, k.shape[2], d).transpose(1, 2)
    vd = v[bt.long()].reshape(b, t, k.shape[2], d).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(t, device="cuda")[None, :]
            < sl.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(lambda: tf.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    bound_ms, bound_by = rpa_bound_ms(q, k, SERVE_LENS, k.shape[1], bw)
    log(f"  timing at the serving shape ({card}): kernel {ms:.4f} ms "
        f"({bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
        f"library (SDPA on pre-gathered dense K/V, gather excluded) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    return {"name": "rpa_decode", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda/csrc/rpa_decode.cu",
            "replaces": "paddle_tpu/ops/pallas/attention.py:885",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def flash_inputs(batch, heads, kv_heads, s, d, dtype, seed, sk=None):
    """q, k, v, dO (B, H, S, D) from a seeded generator on the card (k and
    v with Sk = sk rows when given)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(h, n):
        return torch.randn(batch, h, n, d, generator=g,
                           device="cuda").to(dtype)
    sk = s if sk is None else sk
    return (make(heads, s), make(kv_heads, sk), make(kv_heads, sk),
            make(heads, s))


def flash_compare(name, got, want, dtype):
    """Max abs error; raises past the tolerance (FLASH_REL_TOL)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if dtype == torch.float32:
        atol, rtol = TOL[torch.float32]
        bad = int((err > atol + rtol * w.abs()).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} elements past atol {atol} "
                                 f"rtol {rtol}")
    else:
        diff, ref = (g - w).norm().item(), w.norm().item()
        if diff > FLASH_REL_TOL[dtype] * ref + \
                FLASH_RMS_FLOOR * math.sqrt(w.numel()):
            raise AssertionError(
                f"{name}: L2 error {diff:.3e} > {FLASH_REL_TOL[dtype]} x "
                f"{ref:.3e} + {FLASH_RMS_FLOOR} x sqrt({w.numel()})")
    return err.max().item()


def flash_case(label, batch, heads, kv_heads, s, d, dtype, causal, sk=None,
               *, seed):
    """Each flash kernel against its plain version on the same inputs (the
    backward kernels from the plain forward's out and lse; each launches
    the delta pre-pass itself, which is also held against its plain
    version).  Returns the inputs and the max abs error of each kernel."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = flash_inputs(batch, heads, kv_heads, s, d, dtype, seed, sk)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal)
    delta = fa.flash_bwd_delta(ro, do)
    rd = fa.flash_bwd_delta_ref(ro, do)
    dq = fa.flash_attention_dq(q, k, v, ro, rl, do, causal)
    rq = fa.flash_attention_dq_ref(q, k, v, ro, rl, do, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, ro, rl, do, causal)
    rk, rv = fa.flash_attention_dkv_ref(q, k, v, ro, rl, do, causal)
    torch.cuda.synchronize()
    lse_err = (lse - rl).abs()
    if bool((lse_err > 1e-5 * rl.abs() + 1e-5).any()):
        raise AssertionError(f"{label}: lse past 1e-5 relative, max abs "
                             f"{lse_err.max().item():.3e}")
    errs = {"flash_fwd": max(flash_compare(f"{label} out", out, ro, dtype),
                             lse_err.max().item()),
            "flash_dq": flash_compare(f"{label} dq", dq, rq, dtype),
            "flash_dkv": max(flash_compare(f"{label} dk", dk, rk, dtype),
                             flash_compare(f"{label} dv", dv, rv, dtype)),
            # f32 on both sides, summed in another order
            "flash_bwd_delta": flash_compare(f"{label} delta", delta, rd,
                                             torch.float32)}
    rel = {n: ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
           for n, a, b in (("out", out, ro), ("dq", dq, rq), ("dk", dk, rk),
                           ("dv", dv, rv))}
    log(f"  {label}: B={batch} H={heads} Hkv={kv_heads} "
        f"S={s if sk is None else f'{s}/{sk}'} D={d} "
        f"{str(dtype).replace('torch.', '')} "
        f"{'causal' if causal else 'full'}; max abs err fwd "
        f"{errs['flash_fwd']:.3e} dq {errs['flash_dq']:.3e} dkv "
        f"{errs['flash_dkv']:.3e} delta {errs['flash_bwd_delta']:.3e}; "
        f"rel L2 "
        + " ".join(f"{n} {r:.2e}" for n, r in rel.items()))
    return (q, k, v, do, ro, rl), errs


def flash_visible(sq, sk, causal):
    """Query-key pairs inside the attention pattern."""
    return sq * (sq + 1) // 2 if causal else sq * sk


def attn_bounds(b, h, hkv, sq, sk, d, el, pairs, dtype, bw, prefix):
    """Least time of the forward, dq and dk/dv kernels over ``pairs``
    visible (query, key) pairs of each (batch, head): each input read once
    and each output written once over the memory rate, or the products'
    multiply-adds over the dense rate of the input type; the larger."""
    qo = b * h * sq * d * el            # q, out, dO or dq
    kv = b * hkv * sk * d * el          # k, v, dk or dv
    lse = 4 * b * h * sq                # lse or delta
    # the backward kernels read delta from the pre-pass, not the output
    work = {"fwd": (2, 2 * qo + 2 * kv + lse),          # QK, PV
            "dq": (3, 3 * qo + 2 * kv + 2 * lse),       # + dO V, dS K
            "dkv": (4, 2 * qo + 4 * kv + 2 * lse)}      # + P dO, dS Q
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = 2 * products * b * h * pairs * d / PEAK_OPS[dtype] * 1e3
        t_bytes = nbytes / bw * 1e3
        out[f"{prefix}_{name}"] = (t_ops, "operations") if t_ops >= t_bytes \
            else (t_bytes, "bytes")
    return out


def flash_bounds(q, k, causal, bw):
    """attn_bounds of the dense kernels at these (B, H, S, D) inputs."""
    b, h, sq, d = q.shape
    return attn_bounds(b, h, k.shape[1], sq, k.shape[2], d,
                       q.element_size(), flash_visible(sq, k.shape[2], causal),
                       q.dtype, bw, "flash")


def phase_flash_kernels(card, bw):
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    errs = {}
    cases = [
        # the train phase's shape: B=1, H=32, S=4096, D=128, bf16, causal
        ("training shape", 1, 32, 32, 4096, 128, bf16, True),
        ("GQA 32q/8kv", 1, 32, 8, 2048, 128, bf16, True),
        ("S=4000, partial last tiles of 64 and 128", 1, 8, 8, 4000, 128,
         bf16, True),
        ("S=1000, ragged last tile", 2, 8, 8, 1000, 128, bf16, True),
        ("non-causal Sq=1000 != Sk=1500", 1, 8, 8, 1000, 128, bf16, False,
         1500),
        ("S=1", 2, 8, 2, 1, 128, f16, True),
        ("D=64", 2, 16, 16, 512, 64, bf16, True),
        ("B=2 fp16 D=64", 2, 16, 16, 512, 64, f16, True),
        ("D=96 (the mma.sync kernels)", 1, 8, 8, 333, 96, bf16, True),
        ("non-causal, ragged, GQA", 1, 16, 4, 777, 128, bf16, False),
        ("float16", 1, 16, 16, 1024, 128, f16, True),
        ("float32", 2, 8, 2, 300, 64, f32, True),
        ("float32 non-causal D=128", 1, 4, 4, 200, 128, f32, False),
        ("float32, the train-parity shape (D=16)", 2, 4, 2, 128, 16, f32,
         True),
        # the wgmma forward at fp16 D=64 and 128
        ("fp16 D=128 non-causal, GQA", 1, 16, 4, 777, 128, f16, False),
        ("fp16 D=64, S=1000", 1, 8, 8, 1000, 64, f16, True),
        # head_dim 256: the wgmma forward, the mma.sync backward (DMAX 256)
        ("D=256, GQA 32q/8kv, S=4000", 1, 32, 8, 4000, 256, bf16, True),
        ("D=256 non-causal, GQA 32q/8kv, S=4000", 1, 32, 8, 4000, 256, bf16,
         False),
        ("D=256 fp16", 1, 32, 8, 4000, 256, f16, True),
        ("D=256 fp16 non-causal", 2, 8, 8, 1000, 256, f16, False),
        ("D=256, S=1", 2, 32, 8, 1, 256, bf16, True),
        ("D=256 fp16, S=1", 2, 32, 8, 1, 256, f16, False),
        ("D=144 and 192 (the mma.sync kernels, DMAX 256)", 1, 8, 4, 500,
         144, bf16, True),
        ("D=192 fp16 non-causal Sq=300 != Sk=450", 1, 8, 8, 300, 192, f16,
         False, 450),
        ("float32 D=256", 1, 4, 2, 130, 256, f32, True),
    ]
    main = None
    for i, case in enumerate(cases):
        inputs, e = flash_case(*case, seed=SEED + 10 + i)
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        if main is None:
            main = inputs
    q, k, v, do, out, lse = main
    causal = True
    # each backward kernel alone, from the pre-pass's delta
    delta = fa.flash_bwd_delta(out, do)
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                              causal)),
          "flash_dq": time_ms(lambda: fa.flash_attention_dq(
              q, k, v, out, lse, do, causal, delta=delta)),
          "flash_dkv": time_ms(lambda: fa.flash_attention_dkv(
              q, k, v, out, lse, do, causal, delta=delta)),
          "flash_bwd_delta": time_ms(lambda: fa.flash_bwd_delta(out, do))}
    plain = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd_ref(
                 q, k, v, causal), iters=5, warmup=1),
             "flash_dq": time_ms(lambda: fa.flash_attention_dq_ref(
                 q, k, v, out, lse, do, causal), iters=5, warmup=1),
             "flash_dkv": time_ms(lambda: fa.flash_attention_dkv_ref(
                 q, k, v, out, lse, do, causal), iters=5, warmup=1),
             "flash_bwd_delta": time_ms(lambda: fa.flash_bwd_delta_ref(
                 out, do), iters=5, warmup=1)}
    # library yardstick, never on the path: SDPA forward, and forward +
    # backward (one backward computes dq, dk and dv together)
    lib_fwd = time_ms(lambda: tf.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = tf.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)
    lib_fwd_bwd = time_ms(sdpa_fwd_bwd)
    bounds = flash_bounds(q, k, causal, bw)
    bounds["flash_bwd_delta"] = delta_bound(out, bw)
    log(f"  timing at the training shape ({card}), ms: " + "; ".join(
        f"{n} kernel {ms[n]:.4f} plain {plain[n]:.4f} bound "
        f"{bounds[n][0]:.4f} ({bounds[n][1]})" for n in ms))
    bwd = ms["flash_dq"] + ms["flash_dkv"] + ms["flash_bwd_delta"]
    sdpa_bwd = lib_fwd_bwd - lib_fwd
    log(f"  library (never on the path): SDPA is_causal forward "
        f"{lib_fwd:.4f} ms, forward+backward {lib_fwd_bwd:.4f} ms "
        f"(backward alone {sdpa_bwd:.4f} ms, dq/dk/dv together); the "
        f"backward's three kernels (delta, dq, dk/dv) together {bwd:.4f} ms "
        f"= {bwd / sdpa_bwd:.2f} x SDPA's backward")
    flash_times_d256(card, bw)
    src = {"flash_fwd": ("flash_fwd.cu", "paddle_tpu/ops/pallas/"
                                         "attention.py:99"),
           "flash_dq": ("flash_bwd.cu", "paddle_tpu/ops/pallas/"
                                        "attention.py:214"),
           "flash_dkv": ("flash_bwd.cu", "paddle_tpu/ops/pallas/"
                                         "attention.py:262"),
           # delta = rowsum(dO * O), which both TPU backward kernels
           # recompute in every tile (`_dq_kernel`'s, then `_dkv_kernel`'s)
           "flash_bwd_delta": ("flash_bwd.cu", "paddle_tpu/ops/pallas/"
                                               "attention.py:235")}
    return [{"name": n, "route": "cuda",
             "source": f"paddle_tpu_torch/ops/cuda/csrc/{src[n][0]}",
             "replaces": src[n][1], "launches": None,
             "max_abs_err": errs[n], "ms": ms[n], "plain_ms": plain[n],
             "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
             # SDPA's forward computes the forward's function; no single
             # library call computes dq alone, dk/dv alone or delta
             "library_ms": lib_fwd if n == "flash_fwd" else None}
            for n in ms]


def flash_times_d256(card, bw):
    """The flash kernels at head_dim 256 (B=1, H=8, S=4096, bf16, causal;
    no path of the port runs it, its users bring their own models): kernel,
    plain and SDPA times beside the bounds, printed only."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = flash_inputs(1, 8, 8, 4096, 256, torch.bfloat16,
                               SEED + 300)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, True)
    delta = fa.flash_bwd_delta(out, do)
    ms = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                              True)),
          "flash_dq": time_ms(lambda: fa.flash_attention_dq(
              q, k, v, out, lse, do, True, delta=delta)),
          "flash_dkv": time_ms(lambda: fa.flash_attention_dkv(
              q, k, v, out, lse, do, True, delta=delta))}
    plain = {"flash_fwd": time_ms(lambda: fa.flash_attention_fwd_ref(
                 q, k, v, True), iters=5, warmup=1),
             "flash_dq": time_ms(lambda: fa.flash_attention_dq_ref(
                 q, k, v, out, lse, do, True), iters=5, warmup=1),
             "flash_dkv": time_ms(lambda: fa.flash_attention_dkv_ref(
                 q, k, v, out, lse, do, True), iters=5, warmup=1)}
    lib_fwd = time_ms(lambda: tf.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = tf.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)
    lib_bwd = time_ms(sdpa_fwd_bwd) - lib_fwd
    bounds = flash_bounds(q, k, True, bw)
    log(f"  timing at head_dim 256 (B=1 H=8 S=4096 bf16 causal; {card}), "
        f"ms: " + "; ".join(
            f"{n} kernel {ms[n]:.4f} plain {plain[n]:.4f} bound "
            f"{bounds[n][0]:.4f} ({bounds[n][1]})" for n in ms)
        + f"; library SDPA forward {lib_fwd:.4f}, backward {lib_bwd:.4f}")


def phase_wide_heads(card):
    """C2: the attention functionals at head_dim 136, 192, 256 (the flash
    kernels, zero-padded to a multiple of 16) and 272 (the plain path, as
    the reference routes it) in bf16, fp16 and f32, on the card against
    the same calls on CPU copies, which compute the kernels' plain
    versions: outputs and q/k/v gradients within the flash tolerances (the
    plain path's in f32 only), each call's route counted and its kernels
    launched."""
    from paddle_tpu_torch.nn.functional import (ROUTE_COUNTS,
                                                flash_attn_unpadded,
                                                reset_route_counts,
                                                scaled_dot_product_attention)
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS
    worst = 0.0
    for d in (136, 192, 256, 272):
        kernel = d <= 256
        route = "flash" if d % 16 == 0 else "flash_padded"
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            g = torch.Generator().manual_seed(SEED + d)
            b, s, h, hkv, t = 2, 256, 8, 2, 300
            cu = [0, 100, 101, t]
            dense = [torch.randn(b, s, n, d, generator=g).to(dtype)
                     for n in (h, hkv, hkv, h)]
            packed = [torch.randn(t, n, d, generator=g).to(dtype)
                      for n in (h, hkv, hkv, h)]
            calls = {
                "sdpa": (dense, lambda q, k, v, dev:
                         scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)),
                "varlen": (packed, lambda q, k, v, dev: flash_attn_unpadded(
                    q, k, v, *[torch.tensor(cu, dtype=torch.int32,
                                            device=dev)] * 2, t, t,
                    d ** -0.5, causal=True)[0])}
            for kind, (xs, fn) in calls.items():
                res = {}
                for dev in ("cuda", "cpu"):
                    q, k, v = (x.to(dev).requires_grad_() for x in xs[:3])
                    reset_route_counts()
                    before = dict(LAUNCH_COUNTS)
                    out = fn(q, k, v, dev)
                    out.backward(xs[3].to(dev))
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        want = ({f"{kind}_{route}": 1} if kernel else
                                {f"{kind}_plain:head_dim": 1})
                        if ROUTE_COUNTS != want:
                            raise AssertionError(f"{kind} d={d} {dtype}: "
                                                 f"routes {ROUTE_COUNTS}")
                        names = (("flash_fwd", "flash_dq", "flash_dkv")
                                 if kind == "sdpa" else
                                 ("varlen_fwd", "varlen_dq", "varlen_dkv"))
                        got = {n: LAUNCH_COUNTS[n] - before[n]
                               for n in names}
                        if got != {n: int(kernel) for n in names}:
                            raise AssertionError(f"{kind} d={d} {dtype}: "
                                                 f"launches {got}")
                    res[dev] = [x.detach().cpu() for x in
                                (out, q.grad, k.grad, v.grad)]
                for name, a, w in zip(("out", "dq", "dk", "dv"), res["cuda"],
                                      res["cpu"]):
                    if not torch.isfinite(a.float()).all():
                        raise AssertionError(f"{kind} d={d} {dtype}: "
                                             f"non-finite {name}")
                    # the plain path (d=272) rounds its logits to 16 bits
                    # on both devices: its values are held in f32 only
                    if kernel or dtype == torch.float32:
                        worst = max(worst, flash_compare(
                            f"{kind} d={d} {dtype} {name}", a, w, dtype))
    reset_route_counts()
    log(f"  functionals at head_dim 136/192/256 (flash kernels, padded) and "
        f"272 (plain path), bf16/fp16/f32, dense and packed, card vs CPU "
        f"({card}): routes and launches as expected, outputs and gradients "
        f"within FLASH_REL_TOL / TOL[float32] (max abs err {worst:.3e})")


def delta_bound(out, bw):
    """Least time of the delta pre-pass: dO and O read once, delta (f32)
    written once, or its multiply-adds at the f32 rate; the larger."""
    rows = out.numel() // out.shape[-1]
    t_bytes = (2 * out.numel() * out.element_size() + 4 * rows) / bw * 1e3
    t_ops = 2 * out.numel() / PEAK_OPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the packed-training shape: six documents of Llama-scale lengths packed
# into T = 4096 tokens at Llama-7B's attention width (H = 32, D = 128)
PACKED_DOCS = (1531, 1000, 700, 517, 255, 93)
PACKED_DIMS = (32, 128)                       # heads, head_dim


def cu_of(lengths, device="cuda"):
    """cu_seqlens (int32) of documents of these lengths."""
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                        dtype=torch.int32, device=device)


def segments(cu, t):
    """Lengths of the segments the kernels see: before cu[0], each cu
    interval, and the tail past cu[-1] (empty ones dropped)."""
    edges = [0] + [min(max(int(x), 0), t) for x in cu.tolist()] + [t]
    return [b - a for a, b in zip(edges[:-1], edges[1:]) if b > a]


def varlen_pairs(cu, t, causal):
    """Visible (query, key) pairs of one head of a packed batch."""
    return sum(n * (n + 1) // 2 if causal else n * n
               for n in segments(cu, t))


def varlen_case(label, heads, kv_heads, t, d, dtype, causal, cu, seed):
    """The three varlen kernels against their plain versions on the same
    packed (H, T, D) inputs (the backward kernels from the plain forward's
    out and lse).  Returns the inputs and each kernel's max abs error."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = (x[0] for x in flash_inputs(1, heads, kv_heads, t, d,
                                              dtype, seed))
    cu = torch.tensor(cu, dtype=torch.int32, device="cuda")
    out, lse = fa.varlen_flash_fwd(q, k, v, cu, causal)
    ro, rl = fa.varlen_flash_fwd_ref(q, k, v, cu, causal)
    # the pre-pass on the (H, T, D) view, f32 on both sides
    flash_compare(f"{label} delta", fa.flash_bwd_delta(ro, do),
                  fa.flash_bwd_delta_ref(ro, do), torch.float32)
    dq = fa.varlen_flash_dq(q, k, v, cu, ro, rl, do, causal)
    rq = fa.varlen_flash_dq_ref(q, k, v, cu, ro, rl, do, causal)
    dk, dv = fa.varlen_flash_dkv(q, k, v, cu, ro, rl, do, causal)
    rk, rv = fa.varlen_flash_dkv_ref(q, k, v, cu, ro, rl, do, causal)
    torch.cuda.synchronize()
    lse_err = (lse - rl).abs()
    if bool((lse_err > 1e-5 * rl.abs() + 1e-5).any()):
        raise AssertionError(f"{label}: lse past 1e-5 relative, max abs "
                             f"{lse_err.max().item():.3e}")
    errs = {"varlen_fwd": max(flash_compare(f"{label} out", out, ro, dtype),
                              lse_err.max().item()),
            "varlen_dq": flash_compare(f"{label} dq", dq, rq, dtype),
            "varlen_dkv": max(flash_compare(f"{label} dk", dk, rk, dtype),
                              flash_compare(f"{label} dv", dv, rv, dtype))}
    log(f"  {label}: H={heads} Hkv={kv_heads} T={t} D={d} "
        f"{str(dtype).replace('torch.', '')} "
        f"{'causal' if causal else 'full'} segments "
        f"{segments(cu, t)}; max abs err fwd {errs['varlen_fwd']:.3e} dq "
        f"{errs['varlen_dq']:.3e} dkv {errs['varlen_dkv']:.3e}")
    return (q, k, v, do, cu, ro, rl), errs


def ragged_pairs(sq, lens, causal):
    """Visible (query, key) pairs of one head, summed over the batch: a
    row at or past the length still sees all its length's keys."""
    total = 0
    for n in lens:
        n = min(max(int(n), 0), sq)
        total += n * (n + 1) // 2 + (sq - n) * n if causal else sq * n
    return total


def ragged_case(label, b, h, sq, sk, d, dtype, causal, lens, seed):
    """The ragged kernel against its plain version on every row; a length
    of 0 gives zeros, rows past a length > 0 do not (the TPU kernel's
    mask).  Returns the inputs and the max abs error."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
               for s in (sq, sk, sk))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = fa.flash_attention_ragged_bhsd(q, k, v, kv_lens, causal)
    want = fa.flash_attention_ragged_bhsd_ref(q, k, v, kv_lens, causal)
    torch.cuda.synchronize()
    err = flash_compare(f"{label} out", got, want, dtype)
    for i, n in enumerate(lens):
        if bool((got[i] == 0).all()) != (n == 0):
            raise AssertionError(f"{label}: sequence {i} (length {n}) is "
                                 f"{'all' if n else 'not all'} zeros")
    log(f"  {label}: B={b} H={h} Sq={sq} Sk={sk} D={d} "
        f"{str(dtype).replace('torch.', '')} "
        f"{'causal' if causal else 'full'} kv_lens={list(lens)}; max abs "
        f"err {err:.3e}")
    return (q, k, v, kv_lens), err


def phase_varlen_kernels(card, bw):
    """varlen_fwd, varlen_dq, varlen_dkv and ragged_fwd against their plain
    versions at the full-width shapes and at edge cases, with kernel,
    plain and library times and the bounds.  Returns the kernels' rows
    (ragged_fwd's launches are this phase's own: no path calls it)."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    heads, d = PACKED_DIMS
    docs = cu_of(PACKED_DOCS).tolist()
    t = docs[-1]
    errs = {}
    cases = [
        ("packed training shape", heads, heads, t, d, bf16, True, docs),
        ("packed, non-causal", heads, heads, t, d, bf16, False, docs),
        ("packed, GQA 32q/8kv", heads, 8, t, d, bf16, True, docs),
        ("float32, one-token documents", 8, 2, 300, 64, f32, True,
         [0, 1, 2, 150, 300]),
        ("fp16 D=64, T=1000 (not a multiple of 64), one-token documents",
         16, 16, 1000, 64, f16, True, [0, 1, 2, 3, 500, 999, 1000]),
        ("tail past cu[-1], non-causal, GQA", 16, 4, 777, 128, bf16, False,
         [0, 100, 400, 700]),
        ("float32 non-causal D=128, a tail", 4, 4, 200, 128, f32, False,
         [0, 50, 150]),
        ("D=256, GQA, one-token document", 8, 2, 1000, 256, bf16, True,
         [0, 300, 301, 700, 1000]),
        ("fp16 D=256 non-causal, a tail", 4, 4, 777, 256, f16, False,
         [0, 100, 400]),
    ]
    main = None
    for i, case in enumerate(cases):
        inputs, e = varlen_case(*case, seed=SEED + 90 + i)
        for name, x in e.items():
            errs[name] = max(errs.get(name, 0.0), x)
        if main is None:
            main = inputs
    q, k, v, do, cu, out, lse = main
    causal = True
    # each backward kernel alone, from the pre-pass's delta
    delta = fa.flash_bwd_delta(out, do)
    ms = {"varlen_fwd": time_ms(lambda: fa.varlen_flash_fwd(q, k, v, cu,
                                                            causal)),
          "varlen_dq": time_ms(lambda: fa.varlen_flash_dq(
              q, k, v, cu, out, lse, do, causal, delta=delta)),
          "varlen_dkv": time_ms(lambda: fa.varlen_flash_dkv(
              q, k, v, cu, out, lse, do, causal, delta=delta))}
    plain = {"varlen_fwd": time_ms(lambda: fa.varlen_flash_fwd_ref(
                 q, k, v, cu, causal), iters=5, warmup=1),
             "varlen_dq": time_ms(lambda: fa.varlen_flash_dq_ref(
                 q, k, v, cu, out, lse, do, causal), iters=5, warmup=1),
             "varlen_dkv": time_ms(lambda: fa.varlen_flash_dkv_ref(
                 q, k, v, cu, out, lse, do, causal), iters=5, warmup=1)}
    # library yardstick, never on the path: SDPA over the (1, H, T, D)
    # views with the block-diagonal causal boolean mask, forward, and
    # forward + backward
    seg = fa.segment_ids(cu, t)
    mask = (seg[:, None] == seg[None, :]) & torch.ones(
        t, t, dtype=torch.bool, device="cuda").tril()
    q4, k4, v4, do4 = (x[None] for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: tf.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

    def sdpa_fwd_bwd():
        o = tf.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        torch.autograd.grad(o, (qg, kg, vg), do4)
    lib_fwd_bwd = time_ms(sdpa_fwd_bwd)
    del mask, qg, kg, vg
    bounds = attn_bounds(1, heads, heads, t, t, d, 2,
                         varlen_pairs(cu, t, causal), bf16, bw, "varlen")
    log(f"  timing at the packed training shape ({card}; "
        f"{varlen_pairs(cu, t, causal):,} visible pairs a head), ms: "
        + "; ".join(f"{n} kernel {ms[n]:.4f} plain {plain[n]:.4f} bound "
                    f"{bounds[n][0]:.4f} ({bounds[n][1]})" for n in ms))
    log(f"  library (never on the path): SDPA with the block-diagonal "
        f"causal mask, forward {lib_fwd:.4f} ms, forward+backward "
        f"{lib_fwd_bwd:.4f} ms (backward alone "
        f"{lib_fwd_bwd - lib_fwd:.4f} ms); the three kernels together "
        f"{sum(ms.values()):.4f} ms")

    # the ragged forward: the serving chunk shape, then edge cases
    s_main, lens_main = 1024, [1024, 1000, 777, 512, 300, 129, 64, 0]
    before = LAUNCH_COUNTS["ragged_fwd"]
    (rq, rk, rv, rl), err = ragged_case(
        "ragged, serving chunk shape", 8, heads, s_main, s_main, d, bf16,
        True, lens_main, SEED + 100)
    ragged_errs = [err]
    for i, case in enumerate([
            ("ragged, float32", 4, 8, 300, 300, 64, f32, True,
             [300, 1, 0, 150]),
            ("ragged, fp16 D=64", 3, 16, 200, 200, 64, f16, True,
             [64, 130, 7]),
            ("ragged, non-causal, Sq < Sk", 3, 8, 100, 333, 128, bf16, False,
             [333, 64, 0])]):
        ragged_errs.append(ragged_case(*case, SEED + 101 + i)[1])
    ragged_launches = LAUNCH_COUNTS["ragged_fwd"] - before
    r_ms = time_ms(lambda: fa.flash_attention_ragged_bhsd(rq, rk, rv, rl,
                                                          True))
    r_plain = time_ms(lambda: fa.flash_attention_ragged_bhsd_ref(
        rq, rk, rv, rl, True), iters=5, warmup=1)
    cols = torch.arange(s_main, device="cuda")
    r_mask = ((cols[None, :] < rl.long()[:, None])[:, None, None, :]
              & torch.ones(s_main, s_main, dtype=torch.bool,
                           device="cuda").tril())
    r_lib = time_ms(lambda: tf.scaled_dot_product_attention(
        rq, rk, rv, attn_mask=r_mask))
    del r_mask
    # bytes: q and out, and the K/V rows below each length (the kernel
    # reads no others); operations: QK and PV over the visible pairs
    b_, el = rq.shape[0], rq.element_size()
    keys = sum(min(n, s_main) for n in lens_main)
    r_bytes = (2 * b_ * heads * s_main * d + 2 * heads * keys * d) * el \
        + 4 * b_
    r_pairs = ragged_pairs(s_main, lens_main, True)
    t_bytes = r_bytes / bw * 1e3
    t_ops = 4 * heads * r_pairs * d / PEAK_OPS[bf16] * 1e3
    r_bound, r_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    log(f"  timing at the ragged serving chunk shape ({card}; {r_pairs:,} "
        f"visible pairs a head): kernel {r_ms:.4f} ms, plain "
        f"{r_plain:.4f} ms, library (SDPA with the kv_lens causal mask) "
        f"{r_lib:.4f} ms, bound {r_bound:.4f} ms ({r_by})")
    src = {"varlen_fwd": ("flash_fwd.cu", "472"),
           "varlen_dq": ("flash_bwd.cu", "568"),
           "varlen_dkv": ("flash_bwd.cu", "614")}
    rows = [{"name": n, "route": "cuda",
             "source": f"paddle_tpu_torch/ops/cuda/csrc/{src[n][0]}",
             "replaces": f"paddle_tpu/ops/pallas/attention.py:{src[n][1]}",
             "launches": None, "launches_in": "packed attention (phase 6)",
             "max_abs_err": errs[n], "ms": ms[n], "plain_ms": plain[n],
             "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
             # SDPA with the mask computes the forward's function; no
             # single library call computes dq alone or dk/dv alone
             "library_ms": lib_fwd if n == "varlen_fwd" else None}
            for n in ms]
    rows.append({"name": "ragged_fwd", "route": "cuda",
                 "source": "paddle_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
                 "replaces": "paddle_tpu/ops/pallas/attention.py:724",
                 "launches": ragged_launches,
                 "launches_in": "its kernel checks (phase 3): no path of "
                                "either package calls it",
                 "max_abs_err": max(ragged_errs), "ms": r_ms,
                 "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
                 "library_ms": r_lib})
    return rows


def qmm_bound_ms(m, k, n, bits, groups, x_el, bw):
    """Least time of one quantized product: x, the K contracted code rows,
    the scales and the output moved once, or its 2*M*K*N multiply-adds at
    the bf16 dense rate; and (second) the f32-FMA ceiling of the same work,
    the rate the kernels' f32 arithmetic can reach at most."""
    nbytes = m * k * x_el + k * n * bits // 8 + groups * n * 4 + m * n * x_el
    t_bytes = nbytes / bw * 1e3
    t_ops = 2 * m * k * n / PEAK_OPS[torch.bfloat16] * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, 2 * m * k * n / PEAK_OPS[torch.float32] * 1e3


def qmm_case(label, m, k, n, bits, group, dtype, seed, quiet=False):
    """The quantized matmul kernel against its plain version on one shape
    (weights N(0, 0.02), quantized on the card); returns the inputs and the
    max abs error."""
    from paddle_tpu_torch.ops.cuda.quant_matmul import (qmm_route,
                                                        quant_matmul,
                                                        quant_matmul_ref)
    from paddle_tpu_torch.quantize.core import quantize_weight
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(k, n, generator=g, device="cuda") * 0.02
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    qw, s, grp = quantize_weight(w, bits=bits, group=group)
    del w
    got = quant_matmul(x, qw, s, bits=bits, group=grp)
    want = quant_matmul_ref(x, qw, s, bits=bits, group=grp)
    torch.cuda.synchronize()
    diff = (got.float() - want.float())
    rel = (diff.norm() / want.float().norm()).item()
    err = diff.abs().max().item()
    if not quiet:
        log(f"  {label}: int{bits} M={m} K={k} N={n} group={grp} "
            f"{str(dtype).replace('torch.', '')} ({qmm_route(dtype, grp)})"
            f": rel L2 {rel:.2e} (tol "
            f"{QMM_REL_TOL[dtype]:g}), max abs err {err:.3e}")
    if not torch.isfinite(got).all() or rel > QMM_REL_TOL[dtype]:
        raise AssertionError(f"{label}: quantized matmul kernel disagrees "
                             f"with its plain version: rel L2 {rel:.3e}")
    return (x, qw, s, grp), err


def rpa_quant_case(label, batch, heads, kv_heads, d, page, max_pages,
                   num_pages, lens, dtype, seed):
    """The decode kernel over int8 pools (codes and scales from
    quantize_kv_rows of random rows; page 0 full of garbage codes and
    scales) against its plain version."""
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode, ragged_paged_attention_decode_ref)
    q, k, v, bt, sl = rpa_inputs(batch, heads, kv_heads, d, page, max_pages,
                                 num_pages, lens, torch.float32, seed)
    (kq, ks), (vq, vs) = quant_pools(k, v)
    del k, v
    q = q.to(dtype)
    got = ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks,
                                        v_scales=vs)
    want = ragged_paged_attention_decode_ref(q, kq, vq, bt, sl, None, ks, vs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[dtype]
    bad = err > atol + rtol * want.float().abs()
    log(f"  {label}: B={batch} H={heads} Hkv={kv_heads} D={d} page={page} "
        f"{str(dtype).replace('torch.', '')} int8 pools lens={list(lens)} "
        f"max_abs_err={err.max().item():.3e} (atol {atol:g}, rtol {rtol:g})")
    if bool(bad.any()) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version on {int(bad.sum())} elements")
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    if zero_rows and bool(got[zero_rows].ne(0).any()):
        raise AssertionError(f"{label}: inert rows (len 0) are not zero")
    return (q, kq, vq, bt, sl, ks, vs), err.max().item()


def phase_quant_kernels(card, bw):
    """qmm_i8, qmm_i4 and rpa_decode_quant against their plain versions at
    the quantized serve's shapes and at edge cases, on both of the
    quantized matmul's routes, with times."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode, ragged_paged_attention_decode_ref)
    from paddle_tpu_torch.ops.cuda.quant_matmul import (qmm_route,
                                                        quant_matmul,
                                                        quant_matmul_ref)
    from paddle_tpu_torch.quantize.core import dequantize_weight
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # the quantized serve's products (bf16 x, group 128) take the tensor
    # cores
    if qmm_route(bf16, 128) != "tensor_cores":
        raise AssertionError("the serve's quantized products would not "
                             "take the tensor-core route")
    rows = []
    for bits in (8, 4):
        name = f"qmm_i{bits}"
        errs = []
        # the serve's shapes: decode (M=8) and prefill-chunk (M=256) rows
        # through every Linear, and the prefill's lm_head on one row
        main = {}
        shapes = [(m, k, n) for m in (8, 256) for (k, n) in LLAMA7B_LINEARS
                  if not (m == 256 and n == 32000)] + [(1, 4096, 32000)]
        for i, (m, k, n) in enumerate(shapes):
            inputs, e = qmm_case(f"{name} serve shape", m, k, n, bits, 128,
                                 bf16, SEED + 40 + i, quiet=True)
            errs.append(e)
            main[(m, k, n)] = inputs
        log(f"  {name}: the {len(shapes)} serve shapes agree with the plain "
            f"version (bf16 x, group 128: {qmm_route(bf16, 128)}), max abs "
            f"err {max(errs):.3e}")
        for i, case in enumerate([
                ("fp16 x, decode shape", 8, 4096, 11008, 128, f16),
                ("fp16 x, prefill shape", 256, 4096, 4096, 128, f16),
                ("float32 x, decode shape", 8, 4096, 4096, 128, f32),
                ("float32 x, prefill shape", 256, 4096, 4096, 128, f32),
                ("fp16 x, M=1", 1, 4096, 11008, 128, f16),
                ("M=17 (two row tiles)", 17, 4096, 1024, 128, bf16),
                ("M=40 (ragged M)", 40, 4096, 4096, 128, bf16),
                ("padded K, odd N", 8, 300, 77, 128, bf16),
                ("padded K, odd N, prefill", 256, 300, 77, 64, bf16),
                ("tiled, padded K, odd N", 256, 300, 77, 64, f32),
                ("the tiny model's group", 8, 160, 48, 8, f32),
                ("the tiny model's group, bf16 x", 8, 160, 48, 8, bf16),
                ("odd group (int4 pads a group)", 3, 21, 10, 3, f32)]):
            label, m, k, n, group, dtype = case
            errs.append(qmm_case(label, m, k, n, bits, group, dtype,
                                 SEED + 60 + i)[1])
        # timings at every serve shape; the row reports the decode step's
        # gate/up product (M=8, K=4096, N=11008), and the same product at
        # M=256 (a prefill chunk) under prefill_*
        per_step = 0.0
        timed = {}
        for (m, k, n), (x, qw, s, grp) in main.items():
            t = time_ms(lambda: quant_matmul(x, qw, s, bits=bits, group=grp))
            w16 = dequantize_weight(qw, s, bits, grp, k).to(bf16)
            lib = time_ms(lambda: torch.matmul(x, w16))
            del w16
            (bound, by), ceil = qmm_bound_ms(m, k, n, bits, s.shape[0], 2, bw)
            timed[(m, k, n)] = (t, lib, bound, by)
            if m == 8:
                per_step += t * LLAMA7B_LINEARS[(k, n)]
            log(f"  [{card}] {name} M={m} K={k} N={n}: kernel {t:.4f} ms, "
                f"bound {bound:.4f} ms ({by}; {bound / t:.1%}), f32-FMA "
                f"ceiling {ceil:.4f} ms, library (bf16 matmul, dequantized "
                f"weight) {lib:.4f} ms")
        log(f"  [{card}] {name}: one decode step's 225 launches at M=8 "
            f"take {per_step:.3f} ms of kernel time by these timings")
        x, qw, s, grp = main[(8, 4096, 11008)]
        ms, lib, bound, by = timed[(8, 4096, 11008)]
        plain = time_ms(lambda: quant_matmul_ref(x, qw, s, bits=bits,
                                                 group=grp), iters=10)
        x, qw, s, grp = main[(256, 4096, 11008)]
        p_ms, p_lib, p_bound, p_by = timed[(256, 4096, 11008)]
        p_plain = time_ms(lambda: quant_matmul_ref(x, qw, s, bits=bits,
                                                   group=grp), iters=10)
        del main
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/ops/cuda/csrc/"
                               "quant_matmul.cu",
                     "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:"
                                 + ("84" if bits == 8 else "93"),
                     "launches": None, "max_abs_err": max(errs), "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": lib, "prefill_ms": p_ms,
                     "prefill_plain_ms": p_plain, "prefill_bound_ms": p_bound,
                     "prefill_bound_by": p_by, "prefill_library_ms": p_lib})
    main, err = rpa_quant_case("serving shape, MHA", 8, 32, 32, 128, 16, 64,
                               2048, SERVE_LENS, bf16, SEED + 80)
    errs = [err]
    for i, case in enumerate([
            ("GQA 32q/8kv", 8, 32, 8, 128, 16, 64, 2048, SERVE_LENS, bf16),
            ("float32", 8, 32, 32, 128, 16, 64, 512,
             [0, 1, 15, 16, 33, 200, 511, 1000], f32),
            ("edge: odd page size, D=100, fp16, GQA 12q/4kv", 5, 12, 4, 100,
             7, 20, 200, [0, 1, 7, 8, 140], f16)]):
        errs.append(rpa_quant_case(*case, SEED + 81 + i)[1])
    q, kq, vq, bt, sl, ks, vs = main
    b, h, d = q.shape
    hkv = kq.shape[2]
    t = bt.shape[1] * kq.shape[1]
    ms = time_ms(lambda: ragged_paged_attention_decode(
        q, kq, vq, bt, sl, k_scales=ks, v_scales=vs))
    plain = time_ms(lambda: ragged_paged_attention_decode_ref(
        q, kq, vq, bt, sl, None, ks, vs))
    # library yardstick: SDPA over K/V already gathered and dequantized
    # into a dense (B, H, T, D) layout with a key mask, gather not timed
    bl = bt.long()
    kd = (kq[bl].float() * ks[bl]).to(bf16).reshape(b, t, hkv, d)
    vd = (vq[bl].float() * vs[bl]).to(bf16).reshape(b, t, hkv, d)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    mask = (torch.arange(t, device="cuda")[None, :]
            < sl.long()[:, None])[:, None, None, :]
    lib = time_ms(lambda: tf.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask))
    bound, by = rpa_bound_ms(q, kq, SERVE_LENS, 16, bw, scaled=True)
    log(f"  [{card}] rpa_decode_quant at the serving shape: kernel "
        f"{ms:.4f} ms ({bound / ms:.1%} of the bound), plain {plain:.4f} "
        f"ms, library (SDPA on pre-gathered dequantized dense K/V) "
        f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
    rows.append({"name": "rpa_decode_quant", "route": "cuda",
                 "source": "paddle_tpu_torch/ops/cuda/csrc/rpa_decode.cu",
                 "replaces": "paddle_tpu/ops/pallas/attention.py:896",
                 "launches": None, "max_abs_err": max(errs), "ms": ms,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                 "library_ms": lib})
    return rows


def decode_shapes(vocab: int):
    """The decode kernels' further timing shapes (label, lengths, table
    width): the served decode's own lengths (the first eight serve prompts
    after their 32 generated tokens, tables 64 pages wide as the engine's)
    and a long context (4 sequences of 4096 tokens, tables 256 wide)."""
    served = [len(p) + 32 for p in serve_prompts(SEED, vocab)[:8]]
    return [("served decode", served, 64), ("long context", [4096] * 4, 256)]


def phase_decode_shapes(card, bw) -> None:
    """rpa_decode and rpa_decode_quant at decode_shapes' shapes (H=Hkv=32,
    D=128, page 16, bf16 q): each against its plain version, timed beside
    its bound and the SDPA yardstick on pre-gathered dense K/V."""
    import torch.nn.functional as tf
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode, ragged_paged_attention_decode_ref)
    bf16 = torch.bfloat16
    for i, (label, lens, width) in enumerate(decode_shapes(32000)):
        b, page = len(lens), 16
        pages = sum(math.ceil(n / page) for n in lens) + 1
        q, k, v, bt, sl = rpa_inputs(b, 32, 32, 128, page, width, pages,
                                     lens, bf16, SEED + 90 + i)
        (kq, ks), (vq, vs) = quant_pools(k.float(), v.float())
        t = width * page
        mask = (torch.arange(t, device="cuda")[None, :]
                < sl.long()[:, None])[:, None, None, :]
        for name, kk, vv, kw in (
                ("rpa_decode", k, v, {}),
                ("rpa_decode_quant", kq, vq, {"k_scales": ks,
                                              "v_scales": vs})):
            got = ragged_paged_attention_decode(q, kk, vv, bt, sl, **kw)
            want = ragged_paged_attention_decode_ref(q, kk, vv, bt, sl,
                                                     None, **kw)
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[bf16]
            if bool((err > atol + rtol * want.float().abs()).any()):
                raise AssertionError(f"{name}, {label}: kernel disagrees "
                                     f"with its plain version")
            ms = time_ms(lambda: ragged_paged_attention_decode(
                q, kk, vv, bt, sl, **kw))
            # the yardstick: SDPA on K/V gathered (and dequantized) into a
            # dense (B, H, T, D) layout, the gather not timed
            bl = bt.long()
            kd, vd = kk[bl].float(), vv[bl].float()
            if kw:
                kd, vd = kd * ks[bl], vd * vs[bl]
            kd, vd = (x.to(bf16).reshape(b, t, 32, 128).transpose(1, 2)
                      .contiguous() for x in (kd, vd))
            lib = time_ms(lambda: tf.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, attn_mask=mask))
            del kd, vd
            bound, by = rpa_bound_ms(q, kk, lens, page, bw, scaled=bool(kw))
            log(f"  [{card}] {name}, {label} (B={b}, lens {lens}, tables "
                f"{width} pages): kernel {ms:.4f} ms ({bound / ms:.1%} of "
                f"the bound), bound {bound:.4f} ms ({by}), library (SDPA on "
                f"pre-gathered dense K/V) {lib:.4f} ms, max abs err "
                f"{err.max().item():.3e}")


# -- phase 4: serve ----------------------------------------------------------

def serve_prompts(seed: int, vocab: int):
    """8 prompts of 16-128 tokens, and 2 that share a 64-token prefix and
    then 8 more tokens that fork mid-block: the second (admitted after the
    first finished) maps 4 cached blocks and copies-on-write the fifth."""
    rng = np.random.default_rng(seed)
    tok = lambda n: [int(x) for x in rng.integers(1, vocab, n)]  # noqa: E731
    prefix, fork = tok(64), tok(8)
    first = prefix + fork + tok(40)
    diverge = first[72] % (vocab - 1) + 1          # != first[72]
    second = prefix + fork + [diverge] + tok(30)
    return ([first] + [tok(int(rng.integers(16, 129))) for _ in range(8)]
            + [second])


def compare_prompts(vocab: int):
    """Four prompts of 20-128 tokens whose first decode step the serve
    phases compare across engines."""
    rng = np.random.default_rng(SEED + 1)
    return [[int(x) for x in rng.integers(1, vocab, n)]
            for n in (20, 57, 96, 128)]


def first_decode_logits(engine, prompts, new_tokens):
    """Prefill every prompt, then run one decode step over all of them;
    return that step's logits for the live rows and cancel the requests."""
    from paddle_tpu_torch.serving.scheduler import RUNNING
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    while True:
        kind, payload = engine.scheduler.next_plan()
        if kind == "prefill":
            engine._run_prefill(*payload)
        elif kind == "decode" and len(payload) == len(reqs):
            engine._run_decode(payload)
            break
        elif kind == "idle":
            raise AssertionError("comparison requests did not start")
    assert all(r.state == RUNNING for r in reqs)
    logits = engine.last_logits[:len(reqs)].float().clone()
    for r in reqs:
        engine.cancel(r.rid)
    return logits


def profile_steps(engine, kind: str, steps: int, card, label: str,
                  fresh=None) -> None:
    """Host wall time of ``steps`` engine steps of ``kind`` without and
    then with torch.profiler, device time by kernel name, launches a step,
    and the device's busy share.  ``fresh``, if given, submits the
    requests of each of the two runs (cancelled after it)."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for profiled in (False, True):
        reqs = fresh() if fresh else []
        torch.cuda.synchronize()
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        for _ in range(steps):
            assert engine.step() == kind
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / steps * 1e3)
        if profiled:
            prof.stop()
        for r in reqs:
            engine.cancel(r.rid)
    plain_ms, wall_ms = walls
    # kernels only: an operator row also carries its kernels' device time
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    log(f"  [{card}] {label}: {plain_ms:.3f} ms host wall unprofiled, "
        f"{wall_ms:.3f} ms profiled; device busy {device_ms:.3f} ms a step "
        f"({device_ms / wall_ms:.1%} of the profiled wall), {launches:.0f} "
        f"kernel launches a step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / steps:9.3f} ms/step "
            f"{e.count / steps:6.0f}x  {e.key[:90]}")


def profile_decode(engine, prompts, card, steps: int = 6) -> None:
    """Where a full decode step's time goes, at batch 8."""
    from paddle_tpu_torch.serving.scheduler import RUNNING
    reqs = [engine.submit(p[:64], 4 * steps) for p in prompts[:8]]
    while any(r.state != RUNNING for r in reqs):
        engine.step()
    profile_steps(engine, "decode", steps, card, "decode step at batch 8")
    for r in reqs:
        engine.cancel(r.rid)


def profile_prefill(engine, vocab: int, card, steps: int = 3) -> None:
    """Where a prefill step's time goes: the full chunks of one prompt of
    ``steps`` chunks, a fresh prompt for each run (the prefix cache finds
    nothing; the request is cancelled before its first decode)."""
    rng = np.random.default_rng(SEED + 2)
    chunk = engine.prefill_chunk

    def fresh():
        prompt = [int(t) for t in rng.integers(1, vocab, steps * chunk)]
        return [engine.submit(prompt, 1)]

    profile_steps(engine, "prefill", steps, card,
                  f"prefill step ({chunk}-token chunk)", fresh)


SERVE_KW = dict(block_size=16, max_batch=8, prefill_chunk=256,
                max_seq_len=1024)


def serve_traffic(engine, cfg, card, new_tokens: int = 32):
    """The serve traffic through ``engine.generate`` (warmed up first): every
    launch count set to 0 just before and read just after; outputs, the
    prefix hit and the copy-on-write checked; the run's numbers printed.
    Returns (launches, engine.stats)."""
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    prompts = serve_prompts(SEED, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    stats = dict(engine.stats)
    peak = torch.cuda.max_memory_allocated()
    prefix = engine.kv.prefix_stats()
    reqs = engine.last_requests
    assert all(len(o) == new_tokens for o in outs), \
        [len(o) for o in outs]
    assert prefix["hits"] >= 1 and prefix["hit_tokens_total"] >= 64, prefix
    assert prefix["cow_copies_total"] >= 1, prefix
    ttft = np.array([(r.first_token_at - r.submitted_at) * 1e3
                     for r in reqs])
    toks = sum(len(o) for o in outs)
    log(f"  served {len(outs)} requests x {new_tokens} tokens; prefix "
        f"cache: {prefix['hits']} hits, {prefix['hit_tokens_total']} hit "
        f"tokens, {prefix['cow_copies_total']} copy-on-write")
    log(f"  [{card}] tokens/s {toks / wall:.1f} ({toks} tokens in "
        f"{wall:.3f} s); TTFT ms mean {ttft.mean():.2f} p50 "
        f"{np.median(ttft):.2f} max {ttft.max():.2f}; decode step ms "
        f"{stats['decode_seconds'] / stats['decode_steps'] * 1e3:.3f}; "
        f"prefill step ms "
        f"{stats['prefill_seconds'] / stats['prefill_steps'] * 1e3:.3f}; "
        f"peak memory {peak / 1e9:.2f} GB")
    return launches, stats


def phase_serve(card):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config,
                                               llama_tiny_config)
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[4/9] serve Llama-7B (full width and depth, bf16, random weights)")
    t0 = time.perf_counter()
    cfg = llama_7b_config()
    model = LlamaForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    log(f"  model: {model.num_params() / 1e9:.3f} B parameters, "
        f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"intermediate {cfg.intermediate_size}, heads "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}, vocab "
        f"{cfg.vocab_size}, built in {time.perf_counter() - t0:.1f} s")
    kw = SERVE_KW
    engine = ServingEngine(model, num_blocks=2048, **kw)
    assert engine._use_kernel, "the engine on the card must use the kernel"
    log(f"  KV pool {engine.kv.pool_bytes() / 1e9:.2f} GB "
        f"({engine.kv.num_blocks} pages of {engine.kv.block_size})")
    engine.warmup()
    launches, stats = serve_traffic(engine, cfg, card)
    expect = stats["decode_steps"] * cfg.num_hidden_layers
    assert launches["rpa_decode"] == expect > 0, (launches, expect)
    log(f"  rpa_decode launches {launches['rpa_decode']} = "
        f"{stats['decode_steps']} decode steps x {cfg.num_hidden_layers} "
        f"layers")

    # first decode step of the kernel engine vs an engine on the plain
    # gather path, same weights and prompts
    cmp_prompts = compare_prompts(cfg.vocab_size)
    plain = ServingEngine(model, num_blocks=256, use_kernel=False, **kw)
    a = first_decode_logits(engine, cmp_prompts, 4)
    b = first_decode_logits(plain, cmp_prompts, 4)
    rel = ((a - b).norm() / b.norm()).item()
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    log(f"  first decode step logits, kernel vs gather path: rel err "
        f"{rel:.3e} (tol {LOGITS_REL_TOL}), max abs "
        f"{(a - b).abs().max().item():.3e} of max |logit| "
        f"{b.abs().max().item():.3e}, argmax agree {agree}/{len(a)}")
    assert torch.isfinite(a).all() and a.shape == (len(cmp_prompts),
                                                   cfg.vocab_size)
    assert rel <= LOGITS_REL_TOL, rel
    del plain, engine, model
    torch.cuda.empty_cache()

    # tiny f32 model: the kernel engine's greedy tokens equal a
    # full-recompute greedy decode
    tiny = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2,
                                              max_position_embeddings=64),
                            seed=SEED)
    small = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(11, 30))]
    got = tiny.generate(small, max_new_tokens=6, block_size=4,
                        num_blocks=64, max_batch=3, prefill_chunk=8,
                        max_seq_len=40)
    ref = []
    for p in small:
        ids, out = list(p), []
        for _ in range(6):
            with torch.no_grad():
                nxt = int(tiny(torch.tensor([ids], device="cuda"))[0, -1]
                          .argmax())
            out.append(nxt)
            ids.append(nxt)
        ref.append(out)
    assert tiny._serving_engine._use_kernel
    assert got == ref, (got, ref)
    log("  tiny f32 llama: engine tokens == full-recompute greedy")
    return launches


# -- phase 5: train -----------------------------------------------------------

def train_layers(total_memory: int, hidden: int, inter: int,
                 vocab: int) -> int:
    """bench.py's bench_llama rule: bf16 parameter + grad + f32 moments =
    12 bytes a parameter within 72 % of the card's memory (the rest for
    activations and workspace), at most 32 layers."""
    per_layer = 4 * hidden * hidden + 3 * hidden * inter + 2 * hidden
    embed = 2 * vocab * hidden
    layers = int((total_memory * 0.72 / 12 - embed) // per_layer)
    return max(1, min(layers, 32))


# hidden, intermediate, heads, seq, vocab, batch of the train phase
TRAIN_DIMS = (4096, 11008, 32, 4096, 32000, 1)


def train_setup():
    """bench_llama's model, optimizer and data at Llama-7B width, the depth
    by train_layers; returns (layers, total memory, model, optimizer,
    step)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    hidden, inter, heads, seq, vocab, batch = TRAIN_DIMS
    total = torch.cuda.get_device_properties(0).total_memory
    layers = train_layers(total, hidden, inter, vocab)
    cfg = LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                      intermediate_size=inter, num_hidden_layers=layers,
                      num_attention_heads=heads, num_key_value_heads=heads,
                      max_position_embeddings=seq, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=SEED)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    # bench_llama's data: ids then labels from RandomState(0)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, vocab, (batch, seq))
                           .astype(np.int64)).cuda()
    labels = torch.from_numpy(rng.randint(0, vocab, (batch, seq))
                              .astype(np.int64)).cuda()

    def step():
        loss = model.compute_loss(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    return layers, total, model, opt, step


def phase_train(card, peak_ops):
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    hidden, _, _, seq, _, batch = TRAIN_DIMS
    layers, total, model, opt, step = train_setup()
    n_params = model.num_params()
    log(f"[5/9] train Llama-7B width, {layers} of 32 layers (bench.py's "
        f"memory rule at {total / 1e9:.1f} GB), batch {batch}, seq {seq}, "
        f"bf16, eager AdamW")
    steps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step()]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = dict(LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    tokens_s = batch * seq / step_s
    # bench_llama's model FLOPs: 6N a token for the parameters + 12 L h s
    # for the attention products
    flops_tok = 6.0 * n_params + 12.0 * layers * hidden * seq
    mfu = tokens_s * flops_tok / peak_ops
    log(f"  {n_params / 1e9:.3f} B parameters; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (warm-up step first, {warm_s:.2f} s)")
    log(f"  [{card}] step {step_s * 1e3:.1f} ms, {tokens_s:,.1f} tokens/s, "
        f"MFU {mfu:.4f} (bench_llama's formula at {peak_ops / 1e12:.0f} "
        f"TFLOP/s), peak memory {peak / 1e9:.2f} GB")
    expect = layers * (steps + 1)
    flash = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")
    log(f"  launches over the {steps + 1} steps: " + ", ".join(
        f"{n} {launches[n]}" for n in flash)
        + f" (layers x steps = {expect})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on the repeated batch: "
                             f"{losses}")
    for n in flash:
        if launches[n] != expect:
            raise AssertionError(f"{n} launched {launches[n]} times, "
                                 f"expected {expect}")
    del model, opt, step
    torch.cuda.empty_cache()
    return launches


def profile_train_step(step, card) -> None:
    """Where a train step's time goes: one more step under torch.profiler
    (after the launch counts were read), device time by kernel and the
    device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator row also carries its kernels' device time
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  [{card}] profiled train step: {wall_ms:.1f} ms wall, device "
        f"busy {device_ms:.1f} ms ({device_ms / wall_ms:.1%}), "
        f"{sum(e.count for e in rows)} kernel launches")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)
    # the top twelve, then the port's own kernels below them
    for e in ranked[:12] + [e for e in ranked[12:] if "flash::" in e.key]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def phase_packed(card):
    """Packed-sequence training attention at Llama-7B's attention width:
    ``flash_attn_unpadded`` forward and backward once for each of 32
    layers, on fresh seeded q/k/v (T = 4096 tokens in six documents,
    causal, bf16).  Every launch count is set to 0 just before and read
    just after; every output and gradient must be finite, and each
    document's must equal dense ``flash_sdpa`` on that document alone."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded, flash_sdpa
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    heads, d = PACKED_DIMS
    layers, bf16 = 32, torch.bfloat16
    cu = cu_of(PACKED_DOCS)
    t, longest, scale = int(cu[-1]), max(PACKED_DOCS), 1.0 / math.sqrt(d)
    log(f"[6/9] packed attention: flash_attn_unpadded forward and backward "
        f"at Llama-7B attention width ({heads} heads x {d}), {layers} "
        f"layers, T={t} in documents {list(PACKED_DOCS)}, bf16, causal")
    inputs = []
    for i in range(layers):
        g = torch.Generator(device="cuda").manual_seed(SEED + 200 + i)
        q, k, v, do = (torch.randn(t, heads, d, generator=g,
                                   device="cuda").to(bf16) for _ in range(4))
        inputs.append([x.requires_grad_() for x in (q, k, v)] + [do])
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
             for _ in range(layers)]

    def run():
        outs = []
        for (q, k, v, do), ev in zip(inputs, marks):
            ev[0].record()
            out, _ = flash_attn_unpadded(q, k, v, cu, cu, longest, longest,
                                         scale, causal=True)
            ev[1].record()
            out.backward(do)
            ev[2].record()
            outs.append(out.detach())
        return outs
    # a warm-up pass, so that the timed run's outputs and gradients come
    # from the caching allocator and not from first cudaMallocs (measured:
    # a layer's backward 3.6-4.2 ms with them, 1.7 ms without)
    run()
    for x in inputs:
        for y in x[:3]:
            y.grad = None
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    fwd_ms = [a.elapsed_time(b) for a, b, _ in marks]
    bwd_ms = [b.elapsed_time(c) for _, b, c in marks]
    log(f"  [{card}] {layers} layers in {wall * 1e3:.1f} ms wall; a layer's "
        f"forward {np.median(fwd_ms):.4f} ms, backward "
        f"{np.median(bwd_ms):.4f} ms (medians, CUDA events around the "
        f"calls)")
    log("  launches: " + ", ".join(
        f"{n} {launches[n]}" for n in ("varlen_fwd", "varlen_dq",
                                       "varlen_dkv", "flash_bwd_delta",
                                       "flash_fwd", "flash_dq",
                                       "flash_dkv")))
    for n in ("varlen_fwd", "varlen_dq", "varlen_dkv", "flash_bwd_delta"):
        if launches[n] != layers:
            raise AssertionError(f"{n} launched {launches[n]} times, "
                                 f"expected {layers}")
    if any(launches[n] for n in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"dense flash kernels launched: {launches}")
    worst = 0.0
    for i, ((q, k, v, _), out) in enumerate(zip(inputs, outs)):
        for name, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            if not torch.isfinite(x).all():
                raise AssertionError(f"layer {i}: non-finite {name}")
    # each document alone through dense flash_sdpa (its kernels; these
    # launches come after the counts were read)
    for i, ((q, k, v, do), out) in enumerate(zip(inputs, outs)):
        for lo, hi in zip(cu[:-1].tolist(), cu[1:].tolist()):
            xs = [x.detach()[lo:hi][None].requires_grad_()
                  for x in (q, k, v)]
            ref, _ = flash_sdpa(*xs, scale, True)
            ref.backward(do[lo:hi][None])
            for name, got, want in (("out", out, ref.detach()),
                                    ("dq", q.grad, xs[0].grad),
                                    ("dk", k.grad, xs[1].grad),
                                    ("dv", v.grad, xs[2].grad)):
                worst = max(worst, flash_compare(
                    f"layer {i} document [{lo}, {hi}) {name}", got[lo:hi],
                    want[0], bf16))
    log(f"  every output and gradient finite; each document's output and "
        f"q/k/v gradients equal dense flash_sdpa on the document alone "
        f"(relative L2 within {FLASH_REL_TOL[bf16]}; max abs err "
        f"{worst:.3e})")
    del inputs, outs
    torch.cuda.empty_cache()
    return launches


def phase_train_parity():
    """A tiny f32 Llama, 3 AdamW steps on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    log("[7/9] train parity: tiny f32 Llama, card vs CPU")
    cfg = llama_tiny_config()            # 2 layers, GQA 4/2, head_dim 16
    on_card = LlamaForCausalLM(cfg, seed=SEED)
    on_cpu = LlamaForCausalLM(cfg, device="cpu", seed=SEED)
    on_cpu.load_state_dict(on_card.state_dict())
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    losses = {}
    for name, model in (("card", on_card), ("cpu", on_cpu)):
        dev = next(model.parameters()).device
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01)
        losses[name] = []
        for _ in range(3):
            loss = model.compute_loss(model(ids.to(dev)), labels.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[name].append(loss.item())
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    cpu_params = dict(on_cpu.named_parameters())
    param_rel = max(((p.detach().cpu() - cpu_params[n].detach()).norm()
                     / cpu_params[n].detach().norm()).item()
                    for n, p in on_card.named_parameters())
    log(f"  losses card {losses['card']} cpu {losses['cpu']}; max relative "
        f"loss difference {loss_rel:.3e} (tol {PARITY_LOSS_RTOL}), max "
        f"parameter relative L2 difference {param_rel:.3e} (tol "
        f"{PARITY_PARAM_RTOL})")
    if not loss_rel <= PARITY_LOSS_RTOL:
        raise AssertionError(f"losses differ: {losses}")
    if not param_rel <= PARITY_PARAM_RTOL:
        raise AssertionError(f"parameters differ by {param_rel:.3e}")
    if not losses["card"][-1] < losses["card"][0]:
        raise AssertionError(f"tiny model loss did not fall: {losses}")


def set_quant_kernels(model, on: bool) -> None:
    """Point every quantized Linear at the kernel (on) or at the plain
    dequantize-then-matmul path (off): the plain comparison engine runs the
    same quantized model."""
    from paddle_tpu_torch.quantize import QuantizedLinear
    for m in model.modules():
        if isinstance(m, QuantizedLinear):
            m.kernel = on


def model_gb(model) -> float:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers())
               ) / 1e9


def quant_serve_run(card, bits: int, kv_quant: str):
    """Llama-7B (bf16, seed weights) quantized on the card to int{bits}
    weights, served with the KV pool in ``kv_quant``: the serve traffic, the
    launch counts of the run, and the first-decode-step logits against the
    plain paths on the same quantized model and against the bf16 model."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    from paddle_tpu_torch.quantize import (QuantizedLinear,
                                           quantize_for_inference)
    from paddle_tpu_torch.serving.engine import ServingEngine
    cfg = llama_7b_config()
    model = LlamaForCausalLM(cfg, seed=SEED)
    cmp_prompts = compare_prompts(cfg.vocab_size)
    flags.set_flags({"serving_kv_quant": "off"})
    ref = first_decode_logits(
        ServingEngine(model, num_blocks=256, **SERVE_KW), cmp_prompts, 4)
    bf16_gb = model_gb(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = quantize_for_inference(model, bits=bits)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    floor = {8: 30.0, 4: 10.0}[bits]
    log(f"  int{bits} weights (group {report['group']}): quantized "
        f"{len(report['layers'])} layers on the card in {quant_s:.1f} s; "
        f"weights {bf16_gb:.2f} GB bf16 -> {model_gb(model):.2f} GB; "
        f"snr_db min {report['snr_db_min']:.2f} (bar {floor:g}) median "
        f"{report['snr_db_median']:.2f}")
    if not report["snr_db_min"] > floor:
        raise AssertionError(f"int{bits} snr_db_min {report['snr_db_min']}")
    qlinears = [m for m in model.modules() if isinstance(m, QuantizedLinear)]
    assert len(qlinears) == 7 * cfg.num_hidden_layers + 1
    assert all(m.kernel for m in qlinears), "quantized Linears off the kernel"
    flags.set_flags({"serving_kv_quant": kv_quant})
    try:
        engine = ServingEngine(model, num_blocks=2048, **SERVE_KW)
        plain = ServingEngine(model, num_blocks=256, use_kernel=False,
                              **SERVE_KW)
    finally:
        flags.set_flags({"serving_kv_quant": "off"})
    assert engine._use_kernel and not plain._use_kernel
    assert engine.kv.quantized == (kv_quant == "int8")
    log(f"  KV pool ({kv_quant if kv_quant != 'off' else 'bf16'}) "
        f"{engine.kv.pool_bytes() / 1e9:.2f} GB ({engine.kv.num_blocks} "
        f"pages of {engine.kv.block_size})")
    engine.warmup()
    launches, stats = serve_traffic(engine, cfg, card)
    steps = stats["prefill_steps"] + stats["decode_steps"]
    rpa = "rpa_decode_quant" if engine.kv.quantized else "rpa_decode"
    expect = {f"qmm_i{bits}": steps * QMM_LAUNCHES_A_STEP,
              rpa: stats["decode_steps"] * cfg.num_hidden_layers}
    log(f"  launches: " + ", ".join(
        f"{n} {launches[n]}" for n in ("qmm_i8", "qmm_i4", "rpa_decode",
                                       "rpa_decode_quant"))
        + f"; {stats['prefill_steps']} prefill + {stats['decode_steps']} "
        f"decode steps x {QMM_LAUNCHES_A_STEP} quantized products, decode "
        f"steps x {cfg.num_hidden_layers} layers")
    for n in ("qmm_i8", "qmm_i4", "rpa_decode", "rpa_decode_quant"):
        if launches[n] != expect.get(n, 0) or (n in expect and not
                                               expect[n] > 0):
            raise AssertionError(f"{n} launched {launches[n]} times, "
                                 f"expected {expect.get(n, 0)}")
    a = first_decode_logits(engine, cmp_prompts, 4)
    set_quant_kernels(model, False)
    try:
        b = first_decode_logits(plain, cmp_prompts, 4)
    finally:
        set_quant_kernels(model, True)
    rel = ((a - b).norm() / b.norm()).item()
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    rel_bf16 = ((a - ref).norm() / ref.norm()).item()
    agree_bf16 = int((a.argmax(-1) == ref.argmax(-1)).sum())
    log(f"  first decode step logits, kernel engine vs plain paths on the "
        f"same quantized model: rel err {rel:.3e} (tol {LOGITS_REL_TOL}), "
        f"argmax agree {agree}/{len(a)}; against the bf16 model's "
        f"(informational): rel err {rel_bf16:.3e}, argmax agree "
        f"{agree_bf16}/{len(a)}")
    assert torch.isfinite(a).all() and a.shape == (len(cmp_prompts),
                                                   cfg.vocab_size)
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"int{bits} kernel vs plain logits {rel:.3e}")
    del plain, engine, model
    torch.cuda.empty_cache()
    return launches


def phase_quant_serve(card):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.quantize import quantize_for_inference
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[8/9] quantized serve: Llama-7B (full width and depth), (a) int8 "
        "weights + int8 KV")
    launches = quant_serve_run(card, 8, "int8")
    log("  (b) int4 weights + bf16 KV")
    launches_b = quant_serve_run(card, 4, "off")
    out = {"qmm_i8": launches["qmm_i8"],
           "rpa_decode_quant": launches["rpa_decode_quant"],
           "qmm_i4": launches_b["qmm_i4"]}

    # tiny f32 Llama, int8 weights (group 8) + int8 KV, card vs CPU
    cfg = llama_tiny_config(num_hidden_layers=2, max_position_embeddings=64)
    on_card = LlamaForCausalLM(cfg, seed=SEED)
    on_cpu = LlamaForCausalLM(cfg, device="cpu", seed=SEED)
    on_cpu.load_state_dict(on_card.state_dict())
    rc = quantize_for_inference(on_card, bits=8, group=8)
    rp = quantize_for_inference(on_cpu, bits=8, group=8)
    assert on_card.lm_head.kernel and not on_cpu.lm_head.kernel
    for name, p in on_card.named_parameters():
        if not torch.equal(p.detach().cpu(),
                           dict(on_cpu.named_parameters())[name].detach()):
            raise AssertionError(f"{name}: codes or scales differ card vs "
                                 f"CPU")
    small = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(11, 30))]
    kw = dict(block_size=4, num_blocks=64, max_batch=3, prefill_chunk=8,
              max_seq_len=40)
    flags.set_flags({"serving_kv_quant": "int8"})
    try:
        engines = [ServingEngine(on_card, **kw),
                   ServingEngine(on_cpu, device="cpu", **kw)]
    finally:
        flags.set_flags({"serving_kv_quant": "off"})
    assert engines[0]._use_kernel and engines[0].kv.quantized
    a, b = (first_decode_logits(e, small, 6) for e in engines)
    rel = ((a.cpu() - b).norm() / b.norm()).item()
    toks = [e.generate(small, max_new_tokens=6) for e in engines]
    log(f"  tiny f32 llama, int8 weights + int8 KV: snr_db min "
        f"{rc['snr_db_min']:.2f} (CPU {rp['snr_db_min']:.2f}); first decode "
        f"logits card vs CPU rel err {rel:.3e} (tol {QUANT_PARITY_RTOL}); "
        f"greedy tokens equal: {toks[0] == toks[1]}")
    if not rel <= QUANT_PARITY_RTOL:
        raise AssertionError(f"tiny quantized logits differ: {rel:.3e}")
    if toks[0] != toks[1]:
        raise AssertionError(f"tiny quantized tokens differ: {toks}")
    return out


def phase_profiles(card) -> None:
    """Where the time goes: torch.profiler breakdowns of 256-token prefill
    chunks and batch-8 decode steps (bf16; int8 weights with the int8 pool;
    int4 weights with the bf16 pool) and of one train step.  They come after every timed phase: a
    profiler run slows the host side of later work in the same process
    (measured on the card: the
    train phase's timed steps took 550-900 ms each after one, 522 ms
    without), while the profiled work itself is unaffected."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    from paddle_tpu_torch.quantize import quantize_for_inference
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[9/9] where the time goes (torch.profiler, after the timed phases)")
    cfg = llama_7b_config()
    prompts = serve_prompts(SEED, cfg.vocab_size)
    for bits, kv, label in ((None, "off", "bf16"),
                            (8, "int8", "int8 weights and int8 KV"),
                            (4, "off", "int4 weights and bf16 KV")):
        model = LlamaForCausalLM(cfg, seed=SEED)
        if bits:
            quantize_for_inference(model, bits=bits)
        flags.set_flags({"serving_kv_quant": kv})
        try:
            engine = ServingEngine(model, num_blocks=2048, **SERVE_KW)
        finally:
            flags.set_flags({"serving_kv_quant": "off"})
        engine.warmup()
        log(f"  serve, {label}:")
        profile_prefill(engine, cfg.vocab_size, card)
        profile_decode(engine, prompts, card)
        del engine, model
        torch.cuda.empty_cache()
    layers, _, model, opt, step = train_setup()
    step()                                   # warm-up
    log(f"  train, {layers} layers:")
    profile_train_step(step, card)
    del model, opt, step
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log("[1/9] device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    card = smi
    bw, bw_key = peak_bw(name)
    log(f"  {name}; {count} device(s); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peak bandwidth {bw / 1e12:.2f} TB/s "
        f"({bw_key})")
    log(smi)

    log("[2/9] build")
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for kname, info in built.items():
        build_report(kname, info)

    log("[3/9] kernel vs plain version")
    rows = [phase_kernel(card, bw)] + phase_flash_kernels(card, bw) + \
        phase_varlen_kernels(card, bw) + phase_quant_kernels(card, bw)
    phase_decode_shapes(card, bw)
    phase_wide_heads(card)
    launches = {"rpa_decode": phase_serve(card)["rpa_decode"]}
    launches.update({n: v for n, v in phase_train(
        card, PEAK_OPS[torch.bfloat16]).items() if n.startswith("flash_")})
    launches.update({n: v for n, v in phase_packed(card).items()
                     if n.startswith("varlen_")})
    phase_train_parity()
    launches.update(phase_quant_serve(card))
    phase_profiles(card)
    launched_in = {"rpa_decode": "serve (phase 4)",
                   "flash_fwd": "train (phase 5)",
                   "flash_dq": "train (phase 5)",
                   "flash_dkv": "train (phase 5)",
                   "flash_bwd_delta": "train (phase 5)",
                   "qmm_i8": "quantized serve (phase 8)",
                   "qmm_i4": "quantized serve (phase 8)",
                   "rpa_decode_quant": "quantized serve (phase 8)"}
    for row in rows:
        if row["name"] in launches:
            row["launches"] = launches[row["name"]]
        row.setdefault("launches_in", launched_in.get(row["name"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
