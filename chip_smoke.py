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
   inputs at the main paths' shapes, plus edge cases (head_dim up to 256;
   the fused optimizer update over SGD, Adam and AdamW, its dtype groups,
   decay flags and odd sizes, the loss scaler's overflow flag set and
   clear, timed at the train phase's 210 parameters with a null, a clear
   and a set flag);
   kernel, plain and library times with CUDA events (L2 flushed between
   launches) and the card's bound for the same work (the ragged flash
   forward, which no path calls, at the serving chunk shape; the flash
   kernels also at head_dim 256; the decode kernels also at the served
   decode's own lengths and at a long context; the quantized matmuls at
   M=8 and M=256 over every Llama-7B Linear, on both routes); the attention
   functionals at head_dim 136, 192, 256 and 272 on the card against the
   same calls on the CPU (the kernels' plain versions), with their routes;
4. serve  — Llama-7B at full width and depth (random weights from a seed,
   bf16) behind ``ServingEngine``, whose two step signatures are captured
   into CUDA graphs by its warmup and replayed at every step: 10 greedy
   requests, launch counts read around the warmup and the run (each
   graph's launches a replay times its replays), 0 recaptures after
   warmup, a decode replay against its body run eagerly on the same
   inputs, first-decode-step logits held against an engine on the plain
   gather path, ``serving.step=error,n=1`` armed once on the captured
   engine (the step raises, ``health_snapshot`` reports it, disarmed the
   same tokens, no recapture), and a tiny f32 model's tokens held against
   a full-recompute greedy reference;
5. train  — Llama-7B width (hidden 4096, intermediate 11008, 32 heads,
   seq 4096, bf16; the layer count by bench.py's memory rule) trained
   with AdamW, bench_llama's optimizer and data: eagerly, one warm-up and
   three timed steps on one batch with launch counts read around them
   (the update's device time by CUDA events around ``opt.step()``); then
   the same model and optimizer through ``TrainStepCapture`` (warmup,
   capture, one replay and three timed replays, each flash kernel once a
   layer and the fused update once a replay, 0 recaptures); losses finite
   and falling;
6. packed attention — ``flash_attn_unpadded`` forward and backward at
   Llama-7B's attention width (32 heads x 128) for each of 32 layers on
   seeded q/k/v, T = 4096 tokens in six documents, causal, bf16: launch
   counts read around the run, outputs and gradients finite, each
   document's equal to dense ``flash_sdpa`` on that document alone;
7. train parity — a tiny f32 Llama takes three AdamW steps on the card
   (through the kernels) and on the CPU (through their plain versions)
   in this process; losses and parameters must agree; then five steps
   with a changing learning rate and the clip through the captured step,
   against the same eager steps on the card and the CPU's step;
8. quantized serve — Llama-7B at full width and depth quantized on the
   card by ``quantize_for_inference``: (a) int8 weights with the int8 KV
   pool, (b) int4 weights with the bf16 pool, each serving phase 4's
   traffic through the captured engine as phase 4 does, the report's SNR
   checked, and first-decode-step logits held against the same quantized
   model on the plain paths (and printed against the bf16 model's); then
   a tiny f32 Llama with int8 weights and int8 KV on the card vs the CPU;
9. amp train — (a) O2 float16 at the train phase's width and depth: the
   float32 Llama cast by ``amp.decorate(level="O2", dtype="float16")``,
   AdamW with float32 moments, a ``GradScaler`` whose first scale
   overflows: the overflowed step leaves every parameter, moment and the
   device step counter bitwise unchanged and the scale falls by
   ``decr_ratio``; three applied steps, each inside
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), losses
   finite and falling; a fourth profiled: the flash kernels once a layer
   in float16 and one fused update kernel; step ms, tokens/s, MFU, peak
   memory; (b) O1 (``auto_cast``) at that width, 2 layers, against the
   same float32 model (linear and matmul in float16, flash_sdpa taken in
   float16, the logits and the gradients, through a GradScaler, within
   AMP_O1_RTOL, which a bfloat16 control and a control whose linears
   skip their last K tile must each fail); (c) resume: model, optimizer
   and scaler state_dicts saved with ``paddle_tpu_torch.save`` after an
   overflowed and two applied steps, loaded into fresh objects, the next
   step bitwise equal on both; (d) a PyLayer and jacobian, hessian, jvp,
   vjp card vs CPU;
10. profiles — torch.profiler breakdowns of 256-token prefill chunks and
   batch-8 decode steps (replays; bf16; int8 weights and KV; int4
   weights; the decode replay's copy-on-write list's share), of one
   eager train step and of one train replay (the update's kernels summed
   apart), each replay's kernels counted by name against its graph's
   record, after every timed phase, since a profiler run slows the host
   side of later work;
11. ops — every op of the port's registry (``paddle_tpu_torch/ops/op.py``)
   on CUDA tensors against the same call on CPU tensors (f32 within 1e-5,
   integer and bool exact; random ops by shape, dtype and determinism of
   their generator): the tensor ops at small shapes, the nn ops at the
   flagship's width (4096 tokens x 4096, softmax_ce over 32000 classes),
   forward and backward, each op that sums thousands of terms within its
   own bound (NN_TOL), the dropout ops' realised keep rate and scale
   there, and ``cross_entropy`` with class weights, ignore_index rows and
   label smoothing at (4096, 32000); the registry
   entries over the hand-written kernels (flash_sdpa, varlen_flash,
   paged_attention, paged_attention_quant, quant_matmul) at phase 3's
   shapes against the kernels' plain versions, each launching its kernel;
   the ``tensor/extension.py`` functions card vs CPU;
12. nn surface and checkpoints — (a) Llama-7B (a ``Layer``) saved with
   ``paddle_tpu_torch.save`` in the reference's checkpoint format and
   loaded into a second Llama-7B built from another seed (the first freed
   before): every tensor bitwise equal, phase 4's prompts give the same
   greedy tokens and bitwise the same first-decode-step logits; save and
   load seconds and the file's GB printed; (b) a model built only from
   the nn surface (Sequential of Linear 4096x11008, GELU, Dropout,
   Linear, LayerNorm) takes 3 AdamW steps with ``clip_grad_norm_`` on
   (8, 512, 4096) f32 inputs, its first step with dropout off equal to
   the CPU's.

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
# Captured train step vs the eager loop on the card and vs the CPU (tiny
# f32 model, 5 steps): against the eager loop the same kernels in the same
# order, only the update's learning rate and bias corrections are f32
# tensors in the graph and f64 Python floats eagerly (one f32 ulp apart);
# against the CPU also the plain versions' other summation order (the
# eager card-vs-CPU parity above reads about 3e-6).  Losses and parameters
# within 1e-5 relative
CAPTURE_RTOL = 1e-5
# Fused optimizer update vs its plain version: the same f32 operations in
# the same order (the kernel's powf may differ from torch's pow in its last
# bit), each output rounded once: float32 outputs within 1e-6 relative,
# 16-bit outputs within one ulp of the plain version's
FU_F32_RTOL = 1e-6
# Ops phase: a registry op on CUDA tensors vs the same call on CPU tensors
OPS_RTOL = OPS_ATOL = 1e-5
# The profiler's kernel names of each counted kernel (the counts name the
# wrapper's entry point; the decode kernel's two entry points and the
# quantized matmul's two widths share one template each)
KERNEL_NAMES = {
    "flash_fwd": r"flash_fwd_\w*kernel", "flash_dq": r"flash_dq_\w*kernel",
    "flash_dkv": r"flash_dkv_\w*kernel",
    "flash_bwd_delta": r"flash_bwd_delta_kernel",
    "rpa_decode": r"rpa_decode_kernel", "rpa_decode_quant": r"rpa_decode_kernel",
    "qmm_i8": r"qmm_(tc|wg|skinny|tiled)_kernel",
    "qmm_i4": r"qmm_(tc|wg|skinny|tiled)_kernel",
    "fused_update": r"fused_update_kernel"}


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
        # the amp phase's O2 path runs the __half kernels at this shape
        ("training shape, float16 (amp phase)", 1, 32, 32, 4096, 128, f16,
         True),
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


# -- phase 3 (cont.): the fused optimizer update -----------------------------------

def train_param_shapes(layers: int):
    """bench_llama's parameters at Llama-7B width, ``layers`` deep, in the
    port's model order: the embedding; each layer's input norm, q/k/v/o,
    post-attention norm, gate/up and down (Paddle's (in, out) layout); the
    final norm; the lm_head (210 tensors at 23 layers)."""
    hidden, inter, _, _, vocab, _ = TRAIN_DIMS
    layer = ([(hidden,)] + [(hidden, hidden)] * 4 + [(hidden,)]
             + [(hidden, inter)] * 2 + [(inter, hidden)])
    return [(vocab, hidden)] + layer * layers + [(hidden,), (hidden, vocab)]


def fu_check(got, want, what) -> float:
    """One tensor of the fused update against the plain version's: f32
    within FU_F32_RTOL relative, 16-bit within one ulp; returns the largest
    absolute difference."""
    mant = {torch.float32: None, torch.float16: 10,
            torch.bfloat16: 7}[got.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if mant is None:
        bound = FU_F32_RTOL * w.abs() + 1e-30
    else:
        bound = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -24))) - mant)
    bad = int((diff > bound).sum())
    if bad:
        raise AssertionError(f"fused_update {what}: {bad} elements past "
                             f"the bound (max abs err "
                             f"{diff.max().item():.3e})")
    return diff.max().item()


def fu_tensors(shapes, p_dtype, m_dtype, seed, copies=2):
    """``copies`` identical sets of (params, grads, m1s, m2s) on the card:
    grads ~ 0.1 N(0, 1), m1 ~ 0.01 N(0, 1), m2 ~ U(0, 1e-3); drawn in f32
    a shape at a time (the train shapes' f32 draws would not fit at
    once)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = [([], [], [], []) for _ in range(copies)]
    for shape in shapes:
        vals = (torch.randn(shape, generator=g, device="cuda"),
                0.1 * torch.randn(shape, generator=g, device="cuda"),
                0.01 * torch.randn(shape, generator=g, device="cuda"),
                1e-3 * torch.rand(shape, generator=g, device="cuda"))
        for c in sets:
            for lst, v, dt in zip(c, vals, (p_dtype, p_dtype, m_dtype,
                                            m_dtype)):
                lst.append(v.to(dt, copy=True))
        del vals
    return sets


def fu_skip_checks(fu, sizes, decay):
    """The loss scaler's overflow flag (a 0-dim f32 on the card) over the
    dtype groups amp training takes (f32, bf16, f16, and f16/bf16 with f32
    moments), AdamW and SGD: set, the kernel and the plain version leave
    every p, m1, m2 bitwise as it was; clear, the kernel's result is
    bitwise the plain version's.  Returns the number of cases."""
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    cases = 0
    for kind in (fu.SGD, fu.ADAM):
        for pdt, mdt in ((f32, f32), (bf16, bf16), (f16, f16), (f16, f32),
                         (bf16, f32)):
            if kind == fu.SGD and mdt != pdt:
                continue
            a, b = fu_tensors(sizes, pdt, mdt, SEED + 92)
            ms = (lambda t: t[2:]) if kind == fu.ADAM else \
                (lambda t: (None, None))
            old = [[x.clone() for x in lst] for lst in a]
            lr = torch.tensor(1e-2, device="cuda")
            st = torch.tensor(1.0, device="cuda")
            flag = torch.ones((), device="cuda")
            kw = dict(coeff=0.1, skip=flag)
            fu.fused_update(kind, a[0], a[1], *ms(a), decay, lr, st, **kw)
            fu.fused_update_ref(kind, b[0], b[1], *ms(b), decay, lr, st,
                                **kw)
            torch.cuda.synchronize()
            js = (0, 2, 3) if kind == fu.ADAM else (0,)
            for t in (a, b):
                for j in js:
                    for got, was in zip(t[j], old[j]):
                        if not torch.equal(got, was):
                            raise AssertionError(
                                f"fused_update with the flag set changed a "
                                f"tensor ({pdt}/{mdt}, kind {kind})")
            flag.zero_()
            fu.fused_update(kind, a[0], a[1], *ms(a), decay, lr, st, **kw)
            fu.fused_update_ref(kind, b[0], b[1], *ms(b), decay, lr, st,
                                **kw)
            torch.cuda.synchronize()
            for j in js:
                for got, want in zip(a[j], b[j]):
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"fused_update with the flag clear is not "
                            f"bitwise the plain version's ({pdt}/{mdt}, "
                            f"kind {kind}; max abs err "
                            f"{(got.float() - want.float()).abs().max():.3e})")
            cases += 1
            del a, b, old
    return cases


def phase_fused_update(card, bw):
    """The fused update (SGD, Adam, AdamW) against its plain version over
    the dtype groups (f32; bf16; bf16 with f32 moments), mixed decay flags
    and sizes 1, 7, 4095 and 4096 x 11008, two steps each; the overflow
    flag's cases (``fu_skip_checks``); then at the train phase's 210
    parameters (bf16, AdamW) in one table, six of them against the plain
    version, and its time there with a null flag, a clear flag and a set
    one, beside the plain version's (a tensor at a time) and torch's fused
    AdamW (``torch._fused_adamw_``)."""
    from paddle_tpu_torch.ops.cuda import fused_update as fu
    from paddle_tpu_torch.ops.cuda.attention import LAUNCH_COUNTS
    bf16, f32 = torch.bfloat16, torch.float32
    sizes = [(1,), (7,), (4095,), (4096, 11008)]
    decay = [True, False, True, False]
    errs = []
    for kind, name in ((fu.SGD, "SGD"), (fu.ADAM, "Adam"),
                       (fu.ADAM, "AdamW")):
        for pdt, mdt in ((f32, f32), (bf16, bf16), (bf16, f32)):
            if kind == fu.SGD and mdt != pdt:
                continue
            a, b = fu_tensors(sizes, pdt, mdt, SEED + 90)
            flags = decay if name == "AdamW" else [False] * 4
            kw = dict(coeff=0.1 if name == "AdamW" else 0.0)
            before = LAUNCH_COUNTS["fused_update"]
            for step in (1, 2):
                lr = torch.tensor(1e-2 * step, device="cuda")
                st = torch.tensor(float(step), device="cuda")
                fu.fused_update(kind, *a, flags, lr, st, **kw)
                fu.fused_update_ref(kind, *b, flags, lr, st, **kw)
            if LAUNCH_COUNTS["fused_update"] - before != 2:
                raise AssertionError("fused_update: not one launch a call")
            torch.cuda.synchronize()
            err = 0.0
            for j, what in ((0, "p"), (2, "m1"), (3, "m2")):
                if kind == fu.SGD and j:
                    continue
                for i in range(len(sizes)):
                    err = max(err, fu_check(a[j][i], b[j][i],
                                            f"{name} {what}[{i}]"))
            errs.append(err)
            log(f"  fused_update {name}, p {pdt} / moments {mdt}, sizes "
                f"{sizes}, decay {flags if name == 'AdamW' else 'off'}: "
                f"agrees with the plain version (max abs err {err:.3e})")
            del a, b
    n_skip = fu_skip_checks(fu, sizes, decay)
    log(f"  fused_update with the overflow flag, {n_skip} cases (SGD and "
        f"AdamW over f32, bf16, f16, f16/f32 and bf16/f32 moments, sizes "
        f"{sizes}): set, every tensor bitwise unchanged (kernel and plain "
        f"version); clear, bitwise the plain version")
    torch.cuda.empty_cache()
    layers = train_layers(torch.cuda.get_device_properties(0).total_memory,
                          *TRAIN_DIMS[:2], TRAIN_DIMS[4])
    shapes = train_param_shapes(layers)
    ((ps, gs, m1s, m2s),) = fu_tensors(shapes, bf16, bf16, SEED + 91,
                                       copies=1)
    n = sum(p.numel() for p in ps)
    lr = torch.tensor(1e-6, device="cuda")
    st = torch.tensor(3.0, device="cuda")
    flags = [True] * len(ps)
    cache = {}
    # the call the train path makes (all 210 tensors in one table), held to
    # the plain version on the embedding, the first layer's input norm and
    # q projection, the last layer's down projection, the final norm and
    # the lm_head (copies of all 210 would not fit beside them); lr 1e-2
    # here so that the bf16 parameters move by more than an ulp
    idx = [0, 1, 2, len(ps) - 3, len(ps) - 2, len(ps) - 1]
    saved = [(ps[j].clone(), m1s[j].clone(), m2s[j].clone()) for j in idx]
    before = [ps[j].clone() for j in idx]
    lr_check = torch.tensor(1e-2, device="cuda")
    fu.fused_update(fu.ADAM, ps, gs, m1s, m2s, flags, lr_check, st,
                    coeff=0.01, cache=cache)
    fu.fused_update_ref(fu.ADAM, [s[0] for s in saved], [gs[j] for j in idx],
                        [s[1] for s in saved], [s[2] for s in saved],
                        [True] * len(idx), lr_check, st, coeff=0.01)
    torch.cuda.synchronize()
    err = 0.0
    for j, (p0, a0, b0) in zip(idx, saved):
        for got, want, what in ((ps[j], p0, "p"), (m1s[j], a0, "m1"),
                                (m2s[j], b0, "m2")):
            err = max(err, fu_check(got, want, f"train call {what}[{j}] "
                                    f"{tuple(got.shape)}"))
    errs.append(err)
    moved = sum(int((ps[j] != b).sum()) for j, b in zip(idx, before))
    if not moved:
        raise AssertionError("fused_update train call: no parameter moved")
    log(f"  fused_update at the train phase's {len(ps)} parameters in one "
        f"table (bf16, AdamW): tensors {idx} agree with the plain version "
        f"(max abs err {err:.3e}, {moved} parameter elements moved)")
    del saved, before
    ms = time_ms(lambda: fu.fused_update(fu.ADAM, ps, gs, m1s, m2s, flags,
                                         lr, st, coeff=0.01, cache=cache),
                 iters=10, warmup=2)
    # the same call with the loss scaler's flag: clear (the update runs,
    # one more 4-byte read a block) and set (every block returns first)
    flag = torch.zeros((), device="cuda")
    ms_clear = time_ms(lambda: fu.fused_update(
        fu.ADAM, ps, gs, m1s, m2s, flags, lr, st, coeff=0.01, cache=cache,
        skip=flag), iters=10, warmup=2)
    flag.fill_(1.0)
    ms_set = time_ms(lambda: fu.fused_update(
        fu.ADAM, ps, gs, m1s, m2s, flags, lr, st, coeff=0.01, cache=cache,
        skip=flag), iters=10, warmup=2)
    plain = time_ms(lambda: fu.fused_update_ref(fu.ADAM, ps, gs, m1s, m2s,
                                                flags, lr, st, coeff=0.01),
                    iters=3, warmup=1)
    lib = None
    steps = [torch.tensor(3.0, device="cuda") for _ in ps]
    try:
        lib = time_ms(lambda: torch._fused_adamw_(
            ps, gs, m1s, m2s, [], steps, lr=1e-6, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
            iters=10, warmup=2)
    except (RuntimeError, AttributeError, TypeError) as e:
        log(f"  torch._fused_adamw_ not timed: {e}")
    # read p, g, m1, m2 once and write p, m1, m2 once, 2 bytes each
    bound = n * 14 / bw * 1e3
    log(f"  [{card}] fused_update at the train phase's {len(ps)} parameters "
        f"({layers} layers, {n / 1e9:.3f} B, bf16, AdamW): kernel "
        f"{ms:.3f} ms ({bound / ms:.1%} of the bound), plain (a tensor at a "
        f"time) {plain:.3f} ms, library (torch._fused_adamw_) "
        f"{'not timed' if lib is None else f'{lib:.3f} ms'}, bound "
        f"{bound:.3f} ms (bytes)")
    log(f"  [{card}] the same call with the overflow flag: clear "
        f"{ms_clear:.3f} ms (null flag {ms:.3f} ms), set {ms_set:.3f} ms "
        f"(every block returns before it reads a tensor)")
    del ps, gs, m1s, m2s, steps, cache
    torch.cuda.empty_cache()
    return {"name": "fused_update", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda/csrc/fused_update.cu",
            "replaces": "paddle_tpu/optimizer/optimizer.py:330 (the "
                        "XLA-fused AdamW update; no Pallas kernel)",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib, "ms_flag_clear": ms_clear,
            "ms_flag_set": ms_set, "flag_cases_bitwise": n_skip}


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


def first_decode_logits(engine, prompts, new_tokens, eager_check=False):
    """Prefill every prompt, then run one decode step over all of them (a
    replay of the engine's decode graph); return that step's logits for the
    live rows and cancel the requests.  With ``eager_check`` the step's body
    then runs once eagerly on the same static inputs (its writes repeat the
    same slots): its tokens must equal the replay's, and the logits'
    relative L2 difference is printed (0 expected: the same kernels on the
    same inputs)."""
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
    if eager_check:
        assert engine.graphs()["decode"].replays >= 1
        eager = engine._run_eagerly("decode")[:len(reqs)].float()
        rel = ((eager - logits).norm() / logits.norm()).item()
        same = bool(torch.equal(eager.argmax(-1), logits.argmax(-1)))
        log(f"  decode replay vs its body run eagerly on the same inputs: "
            f"tokens equal {same}, logits relative L2 {rel:.3e}")
        if not same:
            raise AssertionError("the replay's tokens differ from the "
                                 "eager body's")
    for r in reqs:
        engine.cancel(r.rid)
    return logits


def check_profiled(rows, launches, replays: int, label: str) -> None:
    """The profiler's kernels against a graph's recorded launches a replay:
    for each counted kernel, the kernels of its name over ``replays``
    replays must be ``launches[name]`` a replay (the wrapper counts run at
    the capture only, so this is what shows the replays launch them)."""
    got = {}
    for name in launches:
        pattern = re.compile(KERNEL_NAMES[name])
        got[name] = sum(e.count for e in rows if pattern.search(e.key)) \
            / replays
    log(f"    {label}: profiler kernels a replay {got}, recorded at the "
        f"capture {dict(launches)}")
    if got != {n: float(v) for n, v in launches.items()}:
        raise AssertionError(f"{label}: the profiler counts {got} kernels a "
                             f"replay, the capture recorded {launches}")


def profile_steps(engine, kind: str, steps: int, card, label: str,
                  fresh=None) -> None:
    """Host wall time of ``steps`` engine steps of ``kind`` (replays of its
    graph) without and then with torch.profiler, device time by kernel
    name, launches a step, the device's busy share, and the counted
    kernels a replay against the graph's record.  ``fresh``, if given,
    submits the requests of each of the two runs (cancelled after it)."""
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
    check_profiled(rows, engine.graphs()[kind].launches, steps, label)
    return device_ms


def profile_decode(engine, prompts, card, steps: int = 6) -> None:
    """Where a full decode step's time goes, at batch 8."""
    from paddle_tpu_torch.serving.scheduler import RUNNING
    reqs = [engine.submit(p[:64], 4 * steps) for p in prompts[:8]]
    while any(r.state != RUNNING for r in reqs):
        engine.step()
    replay_ms = profile_steps(engine, "decode", steps, card,
                              "decode step at batch 8")
    for r in reqs:
        engine.cancel(r.rid)
    if engine._with_copies:
        profile_copy_list(engine, card, replay_ms)


def profile_copy_list(engine, card, replay_ms: float, steps: int = 6):
    """The decode replay's copy-on-write list (a gather and a scatter a
    pool a layer, ``serving/engine.py:224-228``): the same kernels, over
    the engine's pools and a list of the same width that copies page 0
    (the padding sink) onto itself, run eagerly under the profiler;
    their device time a step against the decode replay's."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.attention import paged_kv_copy
    pad = torch.zeros(engine._max_copies, dtype=torch.int64, device="cuda")
    pools = engine.kv.layer_pools()

    def body():
        for layer in pools:
            for a, b in zip(layer[0::2], layer[1::2]):
                paged_kv_copy(a, b, pad, pad)
    body()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            body()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    cow_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    kernels = sum(e.count for e in rows) / steps
    log(f"  [{card}] copy-on-write list ({engine._max_copies} entries, "
        f"{len(pools)} layers): {cow_ms:.3f} ms device time a step in "
        f"{kernels:.0f} kernels, {cow_ms / replay_ms:.1%} of the decode "
        f"replay's {replay_ms:.3f} ms")


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
    """The serve traffic through the captured engine: every launch count set
    to 0 just before ``engine.warmup()`` (an eager run and a capture of each
    step signature) and read just after ``engine.generate``, whose every
    step replays one of the two graphs; outputs, the prefix hit, the
    copy-on-write and 0 recaptures after warmup checked; the run's numbers
    printed.  Returns (the wrapper counts, which count the warmup's and the
    captures' host calls; the launches of the replays, each graph's
    launches a replay times its replays; each graph's launches a replay;
    engine.stats)."""
    from paddle_tpu_torch.jit.api import replayed_launches
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    prompts = serve_prompts(SEED, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # the device span of each decode replay, by CUDA events around it (no
    # profiler: a profiler session slows the host side of later work)
    decode = engine.graphs()["decode"]
    spans = []

    def timed_replay(replay=decode.replay):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        out = replay()
        marks[1].record()
        spans.append(marks)
        return out
    decode.replay = timed_replay
    t0 = time.perf_counter()
    try:
        outs = engine.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
    finally:
        del decode.replay
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    stats = dict(engine.stats)
    span_ms = float(np.mean([a.elapsed_time(b) for a, b in spans]))
    graphs = engine.graphs()
    per_replay = {k: dict(g.launches) for k, g in graphs.items()}
    replayed = replayed_launches(graphs.values())
    recaptures = engine.health_snapshot()["retraces_after_warmup"]
    log(f"  warmup (eager run + capture of both signatures) {capture_s:.2f} "
        f"s; recaptures after warmup {recaptures}; replays: decode "
        f"{graphs['decode'].replays} x {per_replay['decode']}, prefill "
        f"{graphs['prefill'].replays} x {per_replay['prefill']} (kernel "
        f"launches a replay)")
    if recaptures != 0:
        raise AssertionError(f"{recaptures} recaptures after warmup")
    if (graphs["decode"].replays, graphs["prefill"].replays) != (
            stats["decode_steps"], stats["prefill_steps"]):
        raise AssertionError(f"replays {graphs} != steps {stats}")
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
    step_ms = stats["decode_seconds"] / stats["decode_steps"] * 1e3
    log(f"  [{card}] tokens/s {toks / wall:.1f} ({toks} tokens in "
        f"{wall:.3f} s); TTFT ms mean {ttft.mean():.2f} p50 "
        f"{np.median(ttft):.2f} max {ttft.max():.2f}; decode step ms "
        f"{step_ms:.3f} (host wall; the decode replay's device span "
        f"{span_ms:.3f} ms, {span_ms / step_ms:.1%} of it); prefill step ms "
        f"{stats['prefill_seconds'] / stats['prefill_steps'] * 1e3:.3f}; "
        f"peak memory {peak / 1e9:.2f} GB")
    return launches, replayed, per_replay, stats


def free_cuda() -> None:
    """Release what the last phase held (engines hold their graphs, and a
    model caches its engine: a reference cycle) before the next phase
    builds Llama-7B."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def failpoint_on_engine(engine, vocab: int) -> None:
    """``serving.step=error,n=1`` armed once on the captured engine, as
    the reference's tests arm it: the step raises FailpointError on the
    host before any replay; ``health_snapshot()`` turns unhealthy naming
    it; disarmed, the same requests finish with the tokens an undisturbed
    run of the same prompts gave, the engine is healthy again, and
    nothing recaptured."""
    from paddle_tpu_torch.utils import failpoint as fp
    rng = np.random.default_rng(SEED + 7)
    prompts = [[int(x) for x in rng.integers(1, vocab, n)]
               for n in (33, 70)]
    want = engine.generate(prompts, max_new_tokens=8)
    # the trace counter is the process's (phase 4's gather-path engine
    # captured its own graphs): this engine recaptures nothing from here
    base = engine.health_snapshot()["retraces_after_warmup"]
    reqs = [engine.submit(p, 8) for p in prompts]
    with fp.failpoints("serving.step=error,n=1"):
        try:
            engine.step()
        except fp.FailpointError as exc:
            err = exc
        else:
            raise AssertionError("serving.step=error did not raise")
        sick = engine.health_snapshot()
        fired = fp.stats()["serving.step"]["fired"]
    if sick["healthy"] or "FailpointError" not in (sick["last_error"]
                                                   or "") or fired != 1:
        raise AssertionError(f"health after the injected fault: {sick}")
    while any(not r.done for r in reqs):
        engine.step()
    got = [r.output_tokens for r in reqs]
    health = engine.health_snapshot()
    recaptures = health["retraces_after_warmup"] - base
    if got != want or not health["healthy"] or recaptures:
        raise AssertionError(f"after the injected fault: tokens {got} "
                             f"(undisturbed {want}), recaptures "
                             f"{recaptures}, health {health}")
    log(f"  serving.step=error,n=1 on the captured engine: raised "
        f"{type(err).__name__}; health_snapshot healthy "
        f"{sick['healthy']}, last_error {sick['last_error']!r}; disarmed, "
        f"the same {len(prompts)} requests served the undisturbed run's "
        f"tokens, healthy again, recaptures {recaptures}")


def phase_serve(card):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config,
                                               llama_tiny_config)
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[4/12] serve Llama-7B (full width and depth, bf16, random weights)")
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
    host, launches, per_replay, stats = serve_traffic(engine, cfg, card)
    layers = cfg.num_hidden_layers
    if per_replay != {"decode": {"rpa_decode": layers}, "prefill": {}}:
        raise AssertionError(f"launches a replay {per_replay}")
    if not host["rpa_decode"] > 0:
        raise AssertionError("rpa_decode was not launched in the run")
    expect = stats["decode_steps"] * layers
    assert launches["rpa_decode"] == expect > 0, (launches, expect)
    log(f"  rpa_decode launches {launches['rpa_decode']} = "
        f"{stats['decode_steps']} decode replays x {layers} a replay "
        f"(wrapper calls in the run, warmup and capture: "
        f"{host['rpa_decode']})")

    # first decode step of the kernel engine vs an engine on the plain
    # gather path, same weights and prompts
    cmp_prompts = compare_prompts(cfg.vocab_size)
    plain = ServingEngine(model, num_blocks=256, use_kernel=False, **kw)
    a = first_decode_logits(engine, cmp_prompts, 4, eager_check=True)
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
    failpoint_on_engine(engine, cfg.vocab_size)
    del plain, engine, model
    free_cuda()

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
    assert tiny._serving_engine.graphs()["decode"].replays > 0
    assert got == ref, (got, ref)
    log("  tiny f32 llama: captured engine tokens == full-recompute greedy")
    del tiny
    free_cuda()
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


def train_data():
    """bench_llama's data: ids then labels from RandomState(0)."""
    _, _, _, seq, vocab, batch = TRAIN_DIMS
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, vocab, (batch, seq))
                           .astype(np.int64)).cuda()
    labels = torch.from_numpy(rng.randint(0, vocab, (batch, seq))
                              .astype(np.int64)).cuda()
    return ids, labels


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
    ids, labels = train_data()
    update_events = []

    def step():
        loss = model.compute_loss(model(ids), labels)
        loss.backward()
        # the update's device span, CUDA events around it
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        opt.step()
        ev[1].record()
        update_events.append(ev)
        opt.clear_grad()
        return loss.detach()
    step.update_events = update_events
    return layers, total, model, opt, step


def phase_train(card, peak_ops):
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    hidden, _, _, seq, _, batch = TRAIN_DIMS
    layers, total, model, opt, step = train_setup()
    n_params = model.num_params()
    log(f"[5/12] train Llama-7B width, {layers} of 32 layers (bench.py's "
        f"memory rule at {total / 1e9:.1f} GB), batch {batch}, seq {seq}, "
        f"bf16, AdamW: eager, then TrainStepCapture")
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
    update_ms = float(np.mean([a.elapsed_time(b)
                               for a, b in step.update_events[-steps:]]))
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
        + f" (layers x steps = {expect}); fused_update "
        f"{launches['fused_update']} (one a step: every parameter bf16)")
    log(f"  [{card}] eager update (opt.step(), CUDA events): "
        f"{update_ms:.3f} ms a step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on the repeated batch: "
                             f"{losses}")
    for n in flash:
        if launches[n] != expect:
            raise AssertionError(f"{n} launched {launches[n]} times, "
                                 f"expected {expect}")
    if launches["fused_update"] != steps + 1:
        raise AssertionError(f"fused_update launched "
                             f"{launches['fused_update']} times, expected "
                             f"{steps + 1}")
    captured = train_captured(card, peak_ops, model, opt, step_s, losses)
    del model, opt, step
    free_cuda()
    return captured


def lm_loss(model, ids, labels):
    return model.compute_loss(model(ids), labels)


def train_captured(card, peak_ops, model, opt, eager_step_s, eager_losses):
    """The same model and optimizer through ``TrainStepCapture``: every
    launch count set to 0 just before its warmup (forward and backward on a
    zero batch, the update on copies, then the capture) and read after one
    replay and three timed replays.  Losses finite and falling, each flash
    kernel launched once a layer a replay, no recapture.  Returns the
    launches of the replays (a replay's times the replays)."""
    from paddle_tpu_torch.jit import TrainStepCapture
    from paddle_tpu_torch.jit import compile_cache as cc
    from paddle_tpu_torch.jit.api import replayed_launches
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    hidden, _, _, seq, vocab, batch = TRAIN_DIMS
    layers = model.config.num_hidden_layers
    ids, labels = train_data()
    opt.clear_grad()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    step = TrainStepCapture(model, opt, lm_loss)
    step.warmup([ids, labels])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    base = cc.retrace_count()
    losses = [step(ids, labels)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        losses.append(step(ids, labels))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    host = dict(LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    recaptures = cc.retrace_count() - base
    losses = [float(x) for x in losses]
    (graph,) = step.graphs()
    launches = replayed_launches([graph])
    tokens_s = batch * seq / step_s
    flops_tok = 6.0 * model.num_params() + 12.0 * layers * hidden * seq
    log(f"  captured (TrainStepCapture, same model and AdamW): warmup and "
        f"capture {capture_s:.2f} s; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (one replay first); recaptures after warmup {recaptures}")
    log(f"  [{card}] captured step {step_s * 1e3:.1f} ms (eager "
        f"{eager_step_s * 1e3:.1f} ms), {tokens_s:,.1f} tokens/s, MFU "
        f"{tokens_s * flops_tok / peak_ops:.4f}, peak memory "
        f"{peak / 1e9:.2f} GB")
    log(f"  launches a replay {graph.launches} x {graph.replays} replays; "
        f"wrapper calls in the run (warm step and capture): "
        + ", ".join(f"{n} {host[n]}" for n in sorted(graph.launches)))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite captured loss: {losses}")
    if not (losses[-1] < losses[0] < eager_losses[0]):
        raise AssertionError(f"captured losses did not fall: {losses}")
    if recaptures:
        raise AssertionError(f"{recaptures} recaptures after warmup")
    flash = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")
    # one fused update a replay: every parameter is bf16, one dtype group
    want = {**{n: layers for n in flash}, "fused_update": 1}
    if graph.launches != want or graph.replays != 4:
        raise AssertionError(f"captured train step launches "
                             f"{graph.launches} x {graph.replays}")
    if not all(host[n] > 0 for n in want):
        raise AssertionError(f"a kernel was not launched: {host}")
    log(f"  captured update: fused_update {graph.launches['fused_update']} "
        f"a replay (its device time: phase 10's profiled replay)")
    return launches


UPDATE_KERNEL = re.compile(r"fused_update\w*")


def profile_train_step(step, card, label="profiled train step",
                       graph=None) -> None:
    """Where a train step's time goes: one more step under torch.profiler
    (after the launch counts were read), device time by kernel and the
    device's busy share of the step's wall time; for a replay of ``graph``,
    its counted kernels against the graph's record."""
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
    log(f"  [{card}] {label}: {wall_ms:.1f} ms wall, device "
        f"busy {device_ms:.1f} ms ({device_ms / wall_ms:.1%}), "
        f"{sum(e.count for e in rows)} kernel launches")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)
    # the top twelve, then the port's own kernels below them
    for e in ranked[:12] + [e for e in ranked[12:] if "flash::" in e.key
                            or "fused_update" in e.key]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    # the update's kernels (the fused update and the writes of the grads'
    # addresses into its table), and PyTorch's broadcast elementwise
    # kernel, which the unfused update's products with 0-dim device
    # tensors took
    upd = [e for e in rows if "fused_update" in e.key]
    bcast = [e for e in rows if "elementwise_kernel<128, 4>" in e.key]
    log(f"    {label}: update kernels "
        f"{sum(e.self_device_time_total for e in upd) / 1e3:.3f} ms in "
        f"{sum(e.count for e in upd)} launches ("
        + ", ".join(f"{UPDATE_KERNEL.search(e.key).group(0)} {e.count}x "
                    f"{e.self_device_time_total / 1e3:.3f} ms" for e in upd)
        + f"); elementwise_kernel<128, 4>: "
        f"{sum(e.count for e in bcast)} launches, "
        f"{sum(e.self_device_time_total for e in bcast) / 1e3:.3f} ms")
    if bcast:
        raise AssertionError(f"{label}: elementwise_kernel<128, 4> "
                             f"launched {sum(e.count for e in bcast)}x "
                             f"(the unfused update's broadcast passes)")
    if graph is not None:
        check_profiled(rows, graph.launches, 1, label)


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
    log(f"[6/12] packed attention: flash_attn_unpadded forward and backward "
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
    log("[7/12] train parity: tiny f32 Llama, card vs CPU")
    cfg = llama_tiny_config()            # 2 layers, GQA 4/2, head_dim 16
    on_card = LlamaForCausalLM(cfg, seed=SEED)
    on_cpu = LlamaForCausalLM(cfg, device="cpu", seed=SEED)
    on_cpu.load_state_dict(on_card.state_dict())
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    losses = {}
    for name, model in (("card", on_card), ("cpu", on_cpu)):
        dev = next(iter(model.parameters())).device
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
    train_parity_captured()


def train_parity_captured():
    """The tiny f32 Llama through ``TrainStepCapture`` on the card (a CUDA
    graph), 5 steps with a LinearWarmup learning rate stepped between
    calls and the global-norm clip, against the same steps eagerly on the
    card and against the CPU's step (its eager body on the kernels' plain
    versions), both within CAPTURE_RTOL."""
    from paddle_tpu_torch.jit import TrainStepCapture
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup
    cfg = llama_tiny_config()
    models = {"captured": LlamaForCausalLM(cfg, seed=SEED)}
    models["eager"] = LlamaForCausalLM(cfg, seed=SEED)
    models["cpu"] = LlamaForCausalLM(cfg, device="cpu", seed=SEED)
    for name in ("eager", "cpu"):
        models[name].load_state_dict(models["captured"].state_dict())
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    opts = {name: AdamW(learning_rate=LinearWarmup(
        1e-3, warmup_steps=4, start_lr=1e-4, end_lr=1e-3),
        parameters=m.parameters(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(1.0)) for name, m in models.items()}
    steps = {name: TrainStepCapture(models[name], opts[name], lm_loss)
             for name in ("captured", "cpu")}
    losses = {name: [] for name in models}
    lrs = []
    for _ in range(5):
        lrs.append(opts["captured"].get_lr())
        for name, m in models.items():
            dev = next(iter(m.parameters())).device
            if name in steps:
                loss = steps[name](ids, labels)
            else:
                loss = lm_loss(m, ids.to(dev), labels.to(dev))
                loss.backward()
                opts[name].step()
                opts[name].clear_grad()
            losses[name].append(loss.item())
            opts[name]._learning_rate.step()
    (graph,) = steps["captured"].graphs()
    params = {name: dict(m.named_parameters()) for name, m in models.items()}

    def worst(other):
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses["captured"], losses[other]))
        param_rel = max(((p.detach().cpu() - params[other][n].detach()
                          .cpu()).norm() / params[other][n].detach().cpu()
                         .norm()).item()
                        for n, p in params["captured"].items())
        return loss_rel, param_rel

    eager_l, eager_p = worst("eager")
    cpu_l, cpu_p = worst("cpu")
    log(f"  captured tiny f32 step, 5 steps, learning rate "
        f"{lrs}: losses {losses['captured']}; vs eager on the card: loss "
        f"{eager_l:.3e}, parameters {eager_p:.3e}; vs the CPU: loss "
        f"{cpu_l:.3e}, parameters {cpu_p:.3e} (tol {CAPTURE_RTOL} each); "
        f"{graph.replays} replays")
    if not (eager_l <= CAPTURE_RTOL and eager_p <= CAPTURE_RTOL):
        raise AssertionError("captured step differs from the eager loop")
    if not (cpu_l <= CAPTURE_RTOL and cpu_p <= CAPTURE_RTOL):
        raise AssertionError("captured step differs from the CPU's")
    if graph.replays != 5 or not losses["captured"][-1] < \
            losses["captured"][0]:
        raise AssertionError(f"captured tiny step: {losses['captured']}")


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
    host, launches, per_replay, stats = serve_traffic(engine, cfg, card)
    steps = stats["prefill_steps"] + stats["decode_steps"]
    rpa = "rpa_decode_quant" if engine.kv.quantized else "rpa_decode"
    qmm = f"qmm_i{bits}"
    want = {"decode": {qmm: QMM_LAUNCHES_A_STEP,
                       rpa: cfg.num_hidden_layers},
            "prefill": {qmm: QMM_LAUNCHES_A_STEP}}
    if per_replay != want:
        raise AssertionError(f"launches a replay {per_replay}, expected "
                             f"{want}")
    expect = {qmm: steps * QMM_LAUNCHES_A_STEP,
              rpa: stats["decode_steps"] * cfg.num_hidden_layers}
    log(f"  launches of the replays: " + ", ".join(
        f"{n} {launches.get(n, 0)}" for n in ("qmm_i8", "qmm_i4",
                                              "rpa_decode",
                                              "rpa_decode_quant"))
        + f"; {stats['prefill_steps']} prefill + {stats['decode_steps']} "
        f"decode replays x {QMM_LAUNCHES_A_STEP} quantized products, decode "
        f"replays x {cfg.num_hidden_layers} layers (wrapper calls in the "
        f"run, warmup and capture: {qmm} {host[qmm]}, {rpa} {host[rpa]})")
    for n in ("qmm_i8", "qmm_i4", "rpa_decode", "rpa_decode_quant"):
        if launches.get(n, 0) != expect.get(n, 0) or (
                n in expect and not (expect[n] > 0 and host[n] > 0)):
            raise AssertionError(f"{n} launched {launches.get(n, 0)} times, "
                                 f"expected {expect.get(n, 0)}")
    a = first_decode_logits(engine, cmp_prompts, 4, eager_check=True)
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
    free_cuda()
    return launches


def phase_quant_serve(card):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.quantize import quantize_for_inference
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[8/12] quantized serve: Llama-7B (full width and depth), (a) int8 "
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


# -- phase 9: amp train ----------------------------------------------------------

# O2 float16 with dynamic loss scaling: a scale of 2^40 overflows step 1's
# float16 grads (the loss's gradient at a label's logit, about 1/4096, times
# 2^40 passes float16's 65504), and the scale it then falls to, 2^40 x
# 2^-30 = 2^10, leaves them finite
AMP_INIT_SCALE = 2.0 ** 40
AMP_DECR_RATIO = 2.0 ** -30
# O1 (float16 at linear and matmul, the attention in float16 through the
# flash kernels) against the same float32 model's first step, 2 layers: the
# relative L2 of the logits and of all gradients together, the O1 backward
# through a GradScaler at its default scale (2^16) as O1 float16 is trained:
# unscaled, the loss's gradient at a logit, about 1 / (4096 x 32000) =
# 7.6e-9, lies under float16's least subnormal (6.0e-8) and the grads'
# relative L2 reaches 0.26.  The loss is not held: with random weights it
# stays near ln 32000 whatever the products compute (a product that skips
# its last 64-wide K tile moves it by 7e-5).
# The bound lies between the sound run's readings and those of the nearer
# of two controls run in the same phase, each of which must land past it:
# bfloat16 in place of float16 (3 mantissa bits fewer at every product)
# and float16 with every linear skipping its last 64 input features.
# (readings on an H100 80GB HBM3 at 700 W, logits / grads: sound 1.33e-3
# / 1.54e-3, bfloat16 1.07e-2 / 1.24e-2, the skipped tile 0.44 / 0.50; the
# bound is near the geometric mean of the sound and bfloat16 readings)
AMP_O1_RTOL = 4e-3
AMP_SMALL_LAYERS = 2
# the half kernels' names as the profiler shows them
HALF_KERNEL = re.compile(r"<__half\b")


def amp_digest(tensors) -> torch.Tensor:
    """A bitwise fingerprint a tensor: the (wrapping) int64 sums of its raw
    bits and of their squares, read to the host."""
    rows = []
    for t in tensors:
        bits = t.detach().view({2: torch.int16, 4: torch.int32}[
            t.element_size()]).to(torch.int64)
        rows.append(torch.stack([bits.sum(), (bits * bits).sum()]))
        del bits
    return torch.stack(rows).cpu()


def amp_config(layers: int):
    from paddle_tpu_torch.models.llama import LlamaConfig
    hidden, inter, heads, seq, vocab, _ = TRAIN_DIMS
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=inter, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=heads,
                       max_position_embeddings=seq, dtype="float32")


def amp_o2_setup(layers: int, seed: int):
    """A float32 Llama at the train cell's width through
    ``amp.decorate(level="O2", dtype="float16")``, the train cell's AdamW
    with float32 moments (``multi_precision``) and a GradScaler; returns
    (model, optimizer, scaler, step) where ``step()`` is one scaled step
    on the train cell's batch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(amp_config(layers), seed=seed)
    amp.decorate(model, level="O2", dtype="float16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=AMP_INIT_SCALE,
                            decr_ratio=AMP_DECR_RATIO)
    ids, labels = train_data()

    def step():
        loss = model.compute_loss(model(ids), labels)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach()
    return model, opt, scaler, step


def amp_state(model, opt):
    params = list(model.parameters())
    return params + [opt._get_state(n, p) for n in opt._STATE_NAMES
                     for p in params]


def amp_o2_full(card, peak_ops) -> None:
    """(a) O2 float16 at the train cell's width and depth: step 1 overflows
    and changes nothing (every parameter and moment bitwise, the step
    counter 0, the scale down by AMP_DECR_RATIO); then 3 applied steps,
    each inside torch.cuda.set_sync_debug_mode("error"), losses finite and
    falling; a fourth applied step profiled: the flash kernels once a
    layer each in float16, one fused update kernel (float16 parameters,
    float32 moments) and no other update kernel."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    hidden, inter, _, seq, vocab, batch = TRAIN_DIMS
    layers = train_layers(torch.cuda.get_device_properties(0).total_memory,
                          hidden, inter, vocab)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, scaler, step = amp_o2_setup(layers, SEED)
    n_params = model.num_params()
    log(f"  (a) O2 float16, {layers} layers ({n_params / 1e9:.3f} B "
        f"parameters, built in float32 and cast by amp.decorate in "
        f"{time.perf_counter() - t0:.1f} s); AdamW(1e-4, weight_decay "
        f"0.01, multi_precision: float32 moments); GradScaler("
        f"init_loss_scaling=2^{int(math.log2(AMP_INIT_SCALE))}, "
        f"decr_ratio=2^{int(math.log2(AMP_DECR_RATIO))})")
    params = list(model.parameters())
    if {p.dtype for p in params} != {torch.float16}:
        raise AssertionError("decorate left a parameter that is not "
                             "float16")
    state = amp_state(model, opt)          # the moments, made before step 1
    before = amp_digest(state)
    sample = [t.clone() for t in (state[0], state[len(params)],
                                  state[-1])]
    reset_launch_counts()
    losses = [step()]
    torch.cuda.synchronize()
    after = amp_digest(state)
    skipped = int(scaler._found_inf)
    if not skipped or not torch.equal(before, after) or \
            int(opt._global_step) != 0 or not all(
                torch.equal(a, b) for a, b in zip(
                    sample, (state[0], state[len(params)], state[-1]))):
        raise AssertionError(
            f"the overflowed step: found_inf {scaler._found_inf}, state "
            f"unchanged {torch.equal(before, after)}, step counter "
            f"{int(opt._global_step)}")
    scale1 = scaler.get_init_loss_scaling()
    if scale1 != AMP_INIT_SCALE * AMP_DECR_RATIO:
        raise AssertionError(f"scale after the overflow {scale1}")
    if LAUNCH_COUNTS["fused_update"] != 1:
        raise AssertionError(f"fused_update launched "
                             f"{LAUNCH_COUNTS['fused_update']} times")
    log(f"  step 1 overflowed (found_inf): {len(state)} tensors (parameters"
        f", both moments) bitwise unchanged, the device step counter 0, the "
        f"scale {AMP_INIT_SCALE:.4g} -> {scale1:g}; its one fused_update "
        f"launch returned at the flag")
    del sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            losses.append(step())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(step())
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    applied = losses[1:]
    if scaler._found_inf or int(opt._global_step) != len(applied):
        raise AssertionError(f"applied steps: found_inf "
                             f"{scaler._found_inf}, step counter "
                             f"{int(opt._global_step)}")
    if not all(math.isfinite(x) for x in applied) or \
            not applied[-1] < applied[0]:
        raise AssertionError(f"applied losses {applied}")
    tokens_s = batch * seq / step_s
    flops_tok = 6.0 * n_params + 12.0 * layers * hidden * seq
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)} (the overflowed "
        f"step first; {len(applied)} applied, the last profiled); skipped "
        f"steps {skipped}; every step after the first under "
        f"set_sync_debug_mode('error'): no host sync")
    log(f"  [{card}] O2 float16 step {step_s * 1e3:.1f} ms, "
        f"{tokens_s:,.1f} tokens/s, MFU {tokens_s * flops_tok / peak_ops:.4f}"
        f" (bench_llama's formula at {peak_ops / 1e12:.0f} TFLOP/s), peak "
        f"memory {peak / 1e9:.2f} GB")
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        mine = [e for e in rows if re.search(KERNEL_NAMES[name], e.key)]
        half = sum(e.count for e in mine if HALF_KERNEL.search(e.key))
        if half != layers or sum(e.count for e in mine) != layers:
            raise AssertionError(f"{name} in the profiled step: "
                                 f"{[(e.key, e.count) for e in mine]}")
    upd = [e for e in rows if re.search(r"adam|Adam|sgd|SGD|fused_update_"
                                        r"kernel", e.key)]
    if [(e.count, "__half, float" in e.key) for e in upd] != [(1, True)]:
        raise AssertionError(f"update kernels in the profiled step: "
                             f"{[(e.key, e.count) for e in upd]}")
    scaler_rows = [e for e in rows if "fused_update_set_grads" in e.key
                   or "AmpNonfinite" in e.key or "non_finite" in e.key
                   or "unscale" in e.key]
    log(f"  profiled applied step: flash_fwd, flash_dq, flash_dkv "
        f"{layers} each, float16 (<__half>); update: "
        f"{upd[0].key[:70]} x{upd[0].count} "
        f"{upd[0].self_device_time_total / 1e3:.3f} ms; beside it "
        + ", ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in scaler_rows))
    del model, opt, scaler, step, state, params
    free_cuda()


def amp_o1_readings(model, ids, labels, ref=None, scaler=None):
    """One first step of ``model``: (logits, grads, loss) when ``ref`` is
    None, else the relative L2 of the logits and of all gradients together
    against ``ref``'s (grads freed after).  With ``scaler`` the backward
    runs from ``scaler.scale(loss)`` and the grads are divided by its
    scale (a power of 2: exact in float32)."""
    for p in model.parameters():
        p.grad = None
    logits = model(ids)
    loss = model.compute_loss(logits, labels)
    (loss if scaler is None else scaler.scale(loss)).backward()
    inv = 1.0 if scaler is None else 1.0 / scaler.get_init_loss_scaling()
    grads = [p.grad for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    if ref is None:
        return logits.detach().float(), grads, loss.detach()
    r_logits, r_grads, r_loss = ref
    num = torch.zeros((), dtype=torch.float64, device=r_logits.device)
    den = torch.zeros_like(num)
    for g, r in zip(grads, r_grads):
        if g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"O1 grad {g.dtype}, finite "
                                 f"{bool(torch.isfinite(g).all())}")
        num += (g * inv - r).double().square().sum()
        den += r.double().square().sum()
    lg = logits.detach().float()
    return {"logits": ((lg - r_logits).norm() / r_logits.norm()).item(),
            "grads": (num.sqrt() / den.sqrt()).item(),
            "loss": ((loss.detach() - r_loss).abs() / r_loss.abs()).item()}


def amp_o1(card) -> None:
    """(b) O1 at the train cell's width, 2 layers: the float32 model's
    first step, then the same model's under ``auto_cast(level="O1",
    dtype="float16")`` with a GradScaler: linear and matmul give float16,
    the attention takes flash_sdpa with float16 q/k/v, and the logits and
    gradients agree with float32 within AMP_O1_RTOL; two controls,
    bfloat16 and float16 with every linear skipping its last 64 input
    features, must each land past it.  The unscaled float16 backward is
    read and printed too."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    model = LlamaForCausalLM(amp_config(AMP_SMALL_LAYERS), seed=SEED)
    ids, labels = train_data()
    ref = amp_o1_readings(model, ids, labels)
    seen = []
    sdpa, linear = F.scaled_dot_product_attention, F.linear

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return sdpa(q, k, v, *args, **kwargs)

    def skip_last_k_tile(x, weight, bias=None, name=None):
        return linear(x[..., :-64], weight[:-64], bias)

    F.reset_route_counts()
    reset_launch_counts()
    F.scaled_dot_product_attention = spy
    try:
        with amp.auto_cast(level="O1", dtype="float16"):
            w = model.lm_head.weight
            x = torch.randn(8, w.shape[0], device="cuda")
            lin, mm = F.linear(x, w), P.matmul(x, x, transpose_y=True)
            got = amp_o1_readings(model, ids, labels, ref, amp.GradScaler())
    finally:
        F.scaled_dot_product_attention = sdpa
    torch.cuda.synchronize()
    routes = dict(F.ROUTE_COUNTS)
    flash = {n: LAUNCH_COUNTS[n] for n in ("flash_fwd", "flash_dq",
                                           "flash_dkv")}
    with amp.auto_cast(level="O1", dtype="float16"):
        unscaled = amp_o1_readings(model, ids, labels, ref)
    controls = {}
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        controls["bfloat16"] = amp_o1_readings(model, ids, labels, ref,
                                               amp.GradScaler())
    F.linear = skip_last_k_tile
    try:
        with amp.auto_cast(level="O1", dtype="float16"):
            controls["float16, last K tile skipped"] = amp_o1_readings(
                model, ids, labels, ref, amp.GradScaler())
    finally:
        F.linear = linear

    def fmt(r):
        return (f"logits {r['logits']:.3e} grads {r['grads']:.3e} loss "
                f"{r['loss']:.3e}")
    log(f"  (b) O1 float16, {AMP_SMALL_LAYERS} layers (float32 model): "
        f"linear -> {lin.dtype}, matmul -> {mm.dtype}; attention q/k/v "
        f"{sorted({str(d) for t in seen for d in t})}, routes {routes}, "
        f"flash launches {flash}; relative L2 against float32: {fmt(got)} "
        f"(bound {AMP_O1_RTOL}); "
        f"float16 with no loss scaling: {fmt(unscaled)}; "
        + "; ".join(f"control {n}: {fmt(r)}" for n, r in controls.items()))
    if lin.dtype != torch.float16 or mm.dtype != torch.float16 or \
            len(seen) != AMP_SMALL_LAYERS or \
            any(d != torch.float16 for t in seen for d in t) or \
            routes != {"sdpa_flash": AMP_SMALL_LAYERS} or \
            set(flash.values()) != {AMP_SMALL_LAYERS}:
        raise AssertionError(f"O1: linear {lin.dtype}, matmul {mm.dtype}, "
                             f"attention inputs {seen}, routes {routes}, "
                             f"launches {flash}")
    if not (got["logits"] <= AMP_O1_RTOL and got["grads"] <= AMP_O1_RTOL):
        raise AssertionError(f"O1 against float32: {fmt(got)}")
    for n, r in controls.items():
        if not (r["logits"] > AMP_O1_RTOL and r["grads"] > AMP_O1_RTOL):
            raise AssertionError(f"O1 control {n} within the bound, which "
                                 f"then tells no fault apart: {fmt(r)}")
    del model, ref
    free_cuda()


def amp_resume(card) -> None:
    """(c) Resume at the train cell's width, 2 layers, O2 float16 with the
    scaler: 3 steps (the first overflows), the model's, the optimizer's
    and the scaler's state_dicts saved with ``paddle_tpu_torch.save`` and
    loaded into fresh objects (another seed); step 4 on both: parameters,
    moments, step count and scale bitwise equal."""
    import tempfile
    import paddle_tpu_torch as P
    model, opt, scaler, step = amp_o2_setup(AMP_SMALL_LAYERS, SEED)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    skipped_then = scaler.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "amp_resume.pdparams")
        t0 = time.perf_counter()
        P.save({"model": model.state_dict(), "opt": opt.state_dict(),
                "scaler": scaler.state_dict()}, path)
        save_s = time.perf_counter() - t0
        gb = Path(path).stat().st_size / 1e9
        fresh, fopt, fscaler, fstep = amp_o2_setup(AMP_SMALL_LAYERS,
                                                   SEED + 1)
        t0 = time.perf_counter()
        ck = P.load(path)
        fresh.set_state_dict(ck["model"])
        fopt.set_state_dict(ck["opt"])
        fscaler.load_state_dict(ck["scaler"])
        del ck
        load_s = time.perf_counter() - t0
    step()
    fstep()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(amp_state(model, opt),
                                              amp_state(fresh, fopt))]
    steps = (int(opt._global_step), int(fopt._global_step))
    scales = (scaler.get_init_loss_scaling(),
              fscaler.get_init_loss_scaling())
    log(f"  (c) resume, {AMP_SMALL_LAYERS} layers O2 float16: 3 steps "
        f"(scaler then {skipped_then}), saved {gb:.3f} GB in {save_s:.1f} s"
        f", loaded into fresh objects in {load_s:.1f} s; step 4 on both: "
        f"{sum(same)}/{len(same)} tensors bitwise equal, step counts "
        f"{steps}, scales {scales}")
    if not all(same) or steps[0] != steps[1] or scales[0] != scales[1] \
            or steps[0] != 3:
        raise AssertionError("resume is not bitwise")
    del model, opt, scaler, step, fresh, fopt, fscaler, fstep
    free_cuda()


def core_on_card() -> None:
    """(d) A PyLayer with a hand-written backward and jacobian, hessian,
    jvp and vjp on the card against the same calls on the CPU (float32
    within OPS_RTOL/OPS_ATOL)."""
    from paddle_tpu_torch import autograd as A

    class Swish(A.PyLayer):
        @staticmethod
        def forward(ctx, x, beta=1.0):
            s = torch.sigmoid(beta * x)
            ctx.save_for_backward(x, s)
            ctx.beta = beta
            return x * s

        @staticmethod
        def backward(ctx, g):
            x, s = ctx.saved_tensor
            return g * (s + ctx.beta * x * s * (1 - s))

    r = np.random.RandomState(SEED + 20)
    xs = r.randn(256, 4096).astype(np.float32)
    gs = r.randn(256, 4096).astype(np.float32)
    small = r.randn(3, 5).astype(np.float32)
    tang = r.randn(3, 5).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        x = torch.from_numpy(xs).to(dev).requires_grad_(True)
        y = Swish.apply(x, beta=1.5)
        y.backward(torch.from_numpy(gs).to(dev))
        s, v = (torch.from_numpy(a).to(dev) for a in (small, tang))
        f = (lambda a: torch.tanh(a) * a)
        out = [y.detach(), x.grad, A.jacobian(f, s),
               A.hessian(lambda a: (a ** 3 * torch.sin(a)).sum(), s),
               *A.jvp(f, s, v), *A.vjp(f, s, v)]
        res[dev] = [o.detach().cpu() for o in out]
    worst = _ops_agree("autograd (PyLayer, jacobian, hessian, jvp, vjp)",
                       res["cuda"], res["cpu"])
    log(f"  (d) core on the card: a PyLayer (swish, hand-written backward) "
        f"at (256, 4096) and jacobian/hessian/jvp/vjp at (3, 5), card vs "
        f"CPU: largest difference {worst:.3e} (OPS_RTOL/OPS_ATOL)")


def phase_amp(card, peak_ops) -> None:
    log("[9/12] amp train: O2 float16 with dynamic loss scaling at the "
        "train cell's width and depth, O1, resume, the core on the card")
    t0 = time.perf_counter()
    amp_o2_full(card, peak_ops)
    amp_o1(card)
    amp_resume(card)
    core_on_card()
    log(f"  {time.perf_counter() - t0:.1f} s")


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
    log("[10/12] where the time goes (torch.profiler, after the timed phases)")
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
        want = {"rpa_decode_quant" if kv == "int8" else "rpa_decode":
                cfg.num_hidden_layers}
        if bits:
            want[f"qmm_i{bits}"] = QMM_LAUNCHES_A_STEP
        if engine.graphs()["decode"].launches != want:
            raise AssertionError(f"decode launches a replay "
                                 f"{engine.graphs()['decode'].launches}")
        del engine, model
        free_cuda()
    from paddle_tpu_torch.jit import TrainStepCapture
    layers, _, model, opt, step = train_setup()
    step()                                   # warm-up
    log(f"  train, {layers} layers:")
    profile_train_step(step, card, "profiled eager train step")
    ids, labels = train_data()
    captured = TrainStepCapture(model, opt, lm_loss)
    captured(ids, labels)                    # capture, then a replay
    profile_train_step(lambda: captured(ids, labels), card,
                       "profiled train replay", captured.graphs()[0])
    del model, opt, step, captured
    free_cuda()


# -- phase 11: ops ---------------------------------------------------------------

def op_cases(full: bool = False):
    """{op: (args, kwargs)} for every op of the port's registry but the
    random ones and the kernel entries: small numpy inputs from a seed,
    each op's static attributes as keywords (the registry's calling
    convention; domains kept clear of kinks); the nn ops at the flagship's
    width where ``full`` (``nn_op_cases``)."""
    from paddle_tpu_torch.tensor._helpers import encode_index
    r = np.random.RandomState(SEED + 7)

    def f(*s):
        return r.randn(*s).astype(np.float32)

    def pos(*s):
        return (r.rand(*s) + 0.5).astype(np.float32)

    def unit(*s):
        return (r.rand(*s) * 1.6 - 0.8).astype(np.float32)

    def ints(*s, lo=1, hi=40):
        return r.randint(lo, hi, s).astype(np.int32)

    def boolean(*s):
        return r.rand(*s) > 0.5

    def spd(n=3):
        a = r.randn(n, n).astype(np.float32) * 0.3
        return (a @ a.T + 2 * np.eye(n)).astype(np.float32)

    def distinct(*s):
        return r.permutation(int(np.prod(s))).reshape(s).astype(np.float32)

    c = {}
    for n in ("abs", "asinh", "atan", "ceil", "conj", "cos", "cosh",
              "deg2rad", "erf", "exp", "expm1", "floor", "neg", "rad2deg",
              "round", "sigmoid", "sign", "sin", "sinh", "square", "tanh",
              "trunc", "assign", "angle", "real_op", "imag_op"):
        c[n] = ([f(2, 3)], {})
    for n in ("digamma", "lgamma", "log", "log10", "log1p", "log2",
              "reciprocal", "rsqrt", "sqrt"):
        c[n] = ([pos(2, 3)], {})
    c["acosh"] = ([pos(2, 3) + 1], {})
    for n in ("acos", "asin", "atanh", "erfinv"):
        c[n] = ([unit(2, 3)], {})
    c["tan"] = ([unit(2, 3) * 0.6], {})
    c["logit"] = ([r.rand(2, 3).astype(np.float32) * 0.6 + 0.2],
                  dict(eps=1e-6))
    c["stanh"] = ([f(2, 3)], dict(scale_a=0.67, scale_b=1.7159))
    c["softplus_math"] = ([f(2, 3)], dict(beta=1.0, threshold=20.0))
    c["nan_to_num"] = ([np.array([1.0, np.nan, np.inf, -np.inf],
                                 np.float32)],
                       dict(nan=0.0, posinf=1e30, neginf=-1e30))
    c["clip_op"] = ([f(2, 3)], dict(lo=-0.5, hi=0.5))
    c["scale_op"] = ([f(2, 3)], dict(scale=2.0, bias=1.0,
                                     bias_after_scale=False))
    for n in ("isfinite", "isinf", "isnan"):
        c[n] = ([np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, 2.0]],
                          np.float32)], {})
    for n in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
              "fmin", "hypot", "heaviside", "floor_divide", "kron"):
        c[n] = ([f(2, 3), f(2, 3)], {})
    c["divide"] = ([f(2, 3), pos(2, 3)], {})
    for n in ("atan2", "pow_op"):
        c[n] = ([pos(2, 3), pos(2, 3)], {})
    c["remainder"] = ([pos(2, 3), pos(2, 3) + 1.6], {})
    c["ldexp"] = ([f(2, 3), ints(2, 3, lo=0, hi=3)], {})
    for n in ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor"):
        c[n] = ([ints(3, 4), ints(3, 4)], {})
    c["bitwise_not"] = ([ints(3, 4)], {})
    for n in ("bitwise_left_shift", "bitwise_right_shift"):
        c[n] = ([ints(3, 4, lo=0, hi=100), ints(3, 4, lo=0, hi=4)], {})
    x = f(3, 4)
    y = np.where(boolean(3, 4), x, f(3, 4)).astype(np.float32)
    for n in ("equal", "not_equal", "greater_equal", "greater_than",
              "less_equal", "less_than"):
        c[n] = ([x, y], {})
    c["isclose_op"] = ([x, y], dict(rtol=1e-5, atol=1e-8, equal_nan=False))
    for n in ("logical_and", "logical_or", "logical_xor"):
        c[n] = ([boolean(3, 4), boolean(3, 4)], {})
    c["logical_not"] = ([boolean(3, 4)], {})
    c["complex_op"] = ([f(2, 3), f(2, 3)], {})
    c["inner_op"] = ([f(3), f(3)], {})
    c["outer_op"] = ([f(3), f(2)], {})
    c["dot_op"] = ([f(4), f(4)], {})
    c["cross_op"] = ([f(2, 3), f(2, 3)], dict(axis=-1))
    c["lerp"] = ([f(2, 3), f(2, 3), r.rand(2, 3).astype(np.float32)], {})
    c["where_op"] = ([boolean(2, 3), f(2, 3), f(2, 3)], {})
    c["add_n_op"] = ([f(2, 3), f(2, 3), f(2, 3)], {})
    red = dict(axis=1, keepdim=False)
    c["sum_op"] = ([f(3, 4)], dict(axis=(0, 1), keepdim=True, dtype=None))
    for n in ("mean_op", "nansum_op", "nanmean_op", "logsumexp_op"):
        c[n] = ([f(3, 4)], red)
    for n in ("max_op", "min_op"):
        c[n] = ([distinct(3, 4)], red)
    c["prod_op"] = ([pos(3, 4)], dict(axis=None, keepdim=False))
    for n in ("all_op", "any_op"):
        c[n] = ([boolean(3, 4)], red)
    c["count_nonzero_op"] = ([boolean(3, 4).astype(np.float32)], red)
    for n in ("median_op", "nanmedian_op"):
        c[n] = ([distinct(3, 5)], red)
    for n in ("std_op", "var_op"):
        c[n] = ([distinct(3, 4)], dict(axis=1, unbiased=True,
                                       keepdim=False))
    for n in ("quantile_op", "nanquantile_op"):
        c[n] = ([distinct(3, 4)], dict(q=0.3, axis=1, keepdim=False,
                                       interpolation="linear"))
    c["norm_op"] = ([f(3, 4)], dict(p=2.0, axis=1, keepdim=False))
    for n in ("argmax_op", "argmin_op"):
        c[n] = ([distinct(3, 4)], dict(axis=1, keepdim=False,
                                       dtype="int64"))
    for n in ("cumsum_op", "logcumsumexp_op", "cummax_op", "cummin_op"):
        c[n] = ([distinct(2, 4) / 8], dict(axis=1))
    c["cumprod_op"] = ([pos(2, 4)], dict(axis=1))
    c["reshape_op"] = ([f(2, 3)], dict(shape=(3, 2)))
    c["transpose_op"] = ([f(2, 3)], dict(perm=(1, 0)))
    c["squeeze_op"] = ([f(2, 1, 3)], dict(axis=(1,)))
    c["unsqueeze_op"] = ([f(2, 3)], dict(axis=(1,)))
    c["broadcast_to_op"] = ([f(1, 3)], dict(shape=(2, 3)))
    c["tile_op"] = ([f(2, 2)], dict(reps=(2, 1)))
    c["concat_op"] = ([f(2, 3), f(2, 3)], dict(axis=0))
    c["stack_op"] = ([f(2, 3), f(2, 3)], dict(axis=1))
    c["split_op"] = ([f(4, 3)], dict(indices=(1, 3), axis=0))
    c["flip_op"] = ([f(2, 3)], dict(axis=(0,)))
    c["roll_op"] = ([f(2, 3)], dict(shifts=1, axis=1))
    c["rot90_op"] = ([f(2, 3)], dict(k=1, axes=(0, 1)))
    c["moveaxis_op"] = ([f(2, 3, 4)], dict(src=0, dst=2))
    for n in ("tril_op", "triu_op"):
        c[n] = ([f(3, 3)], dict(diagonal=0))
    c["diag_op"] = ([f(3)], dict(offset=1))
    c["diag_embed_op"] = ([f(2, 3)], dict(offset=0, dim1=-2, dim2=-1))
    c["diagonal_op"] = ([f(3, 3)], dict(offset=0, axis1=0, axis2=1))
    c["diff_op"] = ([f(2, 4)], dict(n=1, axis=-1))
    c["trace_op"] = ([f(3, 3)], dict(offset=0, axis1=0, axis2=1))
    c["gather_op"] = ([f(4, 3), np.array([0, 2], np.int32)], dict(axis=0))
    c["gather_nd_op"] = ([f(3, 3), np.array([[0, 1], [2, 2]], np.int32)],
                         {})
    c["index_select_op"] = ([f(4, 3), np.array([1, 3], np.int32)],
                            dict(axis=0))
    c["index_sample_op"] = ([f(2, 4), np.array([[0, 1], [2, 0]], np.int32)],
                            {})
    c["index_add_op"] = ([f(4, 3), np.array([0, 2], np.int32), f(2, 3)],
                         dict(axis=0))
    c["take_along_axis_op"] = ([f(3, 3), np.array([[0, 2], [1, 0], [2, 1]],
                                                  np.int32)], dict(axis=1))
    c["put_along_axis_op"] = ([f(3, 3), np.array([[0], [1], [2]], np.int32),
                               f(3, 1)], dict(axis=1, reduce="add"))
    c["scatter_op"] = ([f(4, 3), np.array([0, 2], np.int32), f(2, 3)],
                       dict(overwrite=True))
    c["scatter_nd_add_op"] = ([f(4, 3), np.array([[0], [2]], np.int32),
                               f(2, 3)], {})
    c["repeat_interleave_op"] = ([f(2, 3)], dict(repeats=2, axis=0))
    c["sort_op"] = ([distinct(3, 4)], dict(axis=-1, descending=True))
    c["argsort_op"] = ([distinct(3, 4)], dict(axis=-1, descending=False,
                                              stable=True))
    c["topk_op"] = ([distinct(3, 4)], dict(k=2, axis=-1, largest=True,
                                           sorted=True))
    c["searchsorted_op"] = ([np.sort(f(6)), f(2, 3)], dict(right=False))
    c["as_strided_op"] = ([f(4, 4)], dict(shape=(2, 2), stride=(4, 1),
                                          offset=1))
    c["multiplex_op"] = ([np.array([[0], [1]], np.int32), f(2, 3), f(2, 3)],
                         {})
    c["masked_fill_op"] = ([f(2, 3), boolean(2, 3),
                            np.array(0.5, np.float32)], {})
    c["unfold_op"] = ([f(6, 2)], dict(axis=0, size=2, step=2))
    static, dyn = encode_index((slice(1, None), np.array([0, 2])))
    c["getitem_op"] = ([f(3, 3)] + [d.numpy() for d in dyn],
                       dict(static=static))
    c["setitem_op"] = ([f(3, 3), np.array(2.0, np.float32)]
                       + [d.numpy() for d in dyn], dict(static=static))
    c["pad_nd"] = ([f(3, 4)], dict(pad_width=((1, 2), (2, 1)),
                                   mode="reflect", value=0.0))
    c["cast_op"] = ([f(2, 3)], dict(dtype="float16", src_dtype=None))
    c["tensordot_op"] = ([f(2, 3), f(3, 2)], dict(axes=1))
    c["einsum_op"] = ([f(2, 3), f(3, 2)], dict(equation="ij,jk->ik"))
    c["matmul_op"] = ([f(2, 3), f(2, 3)], dict(transpose_x=False,
                                               transpose_y=True))
    for n in ("det_op", "slogdet_op", "inv_op"):
        c[n] = ([spd()], {})
    c["cholesky_op"] = ([spd()], dict(upper=False))
    c["matrix_power_op"] = ([spd()], dict(n=2))
    c["pinv_op"] = ([f(3, 2)], dict(rcond=1e-15))
    c["solve_op"] = ([spd(), f(3, 2)], {})
    c["triangular_solve_op"] = ([np.triu(spd()), f(3, 2)],
                                dict(upper=True, transpose=True,
                                     unitriangular=False))
    c.update(nn_op_cases(full))
    c.update(model_op_cases())
    return c


# the nn ops at the flagship's width: (4096 tokens, 4096) f32 inputs,
# softmax_ce over Llama-7B's 32000-word vocabulary
NN_FULL = dict(rows=4096, hidden=4096, vocab=32000)
NN_SMALL = dict(rows=6, hidden=8, vocab=10)
# Bounds of the nn ops whose outputs or gradients are sums over thousands
# of terms (at NN_FULL: 4096 rows, 4096 or 32000 columns), card vs CPU.
# The two devices add the terms in another order, and each partial sum is
# rounded at the scale of the tensor's largest elements (a weight's
# gradient sums 4096 products of unit size: its elements reach ~300), so
# an element that cancels to near 0 carries an absolute error on that
# scale.  Each such op's outputs and gradients are held to
# |card - CPU| <= OPS_RTOL |CPU| + NN_TOL[op] x max|CPU| over the tensor;
# every other op to OPS_RTOL/OPS_ATOL.
NN_TOL = {name: 1e-5 for name in (
    "linear_op",                         # 4096-term dot products
    "embedding_op",                      # the gradient sums 4096 rows
    "layer_norm_op", "rms_norm_op",      # 4096-term statistics, and the
    "batch_norm_train", "batch_norm_infer",   # weights' 4096-row grads
    "group_norm_op", "instance_norm_op",  # 32768/4096-term statistics
    "normalize_op", "softmax_op", "log_softmax_op",   # 4096-term sums
    "softmax_ce",                        # 32000-term logsumexp
    "prelu_op")}                         # one weight: a 16M-term gradient


def nn_op_cases(full: bool):
    """The nn ops of the registry (activations, norms, linear, embedding,
    losses), at NN_FULL where ``full`` else NN_SMALL."""
    dims = NN_FULL if full else NN_SMALL
    n, h, vocab = dims["rows"], dims["hidden"], dims["vocab"]
    r = np.random.RandomState(SEED + 11)

    def f(*s):
        return r.randn(*s).astype(np.float32)

    def away(*s):
        sign = np.where(r.rand(*s) > 0.5, 1.0, -1.0)
        return (sign * (0.2 + r.rand(*s) * 2)).astype(np.float32)

    c = {}
    for name, kw in (("relu", {}), ("relu6", {}), ("hardswish", {}),
                     ("leaky_relu_op", dict(negative_slope=0.1)),
                     ("elu_op", dict(alpha=0.7)),
                     ("selu_op", dict(scale=1.0507009873554805,
                                      alpha=1.6732632423543772)),
                     ("celu_op", dict(alpha=1.3)),
                     ("hardsigmoid_op", dict(slope=0.1666667, offset=0.5)),
                     ("hardtanh_op", dict(mn=-1.0, mx=1.0)),
                     ("softshrink_op", dict(threshold=0.1)),
                     ("hardshrink_op", dict(threshold=0.1)),
                     ("thresholded_relu_op", dict(threshold=0.1,
                                                  value=0.3))):
        c[name] = ([away(n, h)], kw)          # clear of every kink
    for name in ("silu", "mish", "softsign", "log_sigmoid", "tanhshrink"):
        c[name] = ([f(n, h)], {})
    c["gelu_op"] = ([f(n, h)], dict(approximate=False))
    c["softmax_op"] = ([f(n, h)], dict(axis=-1))
    c["log_softmax_op"] = ([f(n, h)], dict(axis=-1))
    c["prelu_op"] = ([away(n, h), np.full((1,), 0.25, np.float32)], {})
    c["linear_op"] = ([f(n, h), f(h, h) / math.sqrt(h), f(h)], {})
    c["embedding_op"] = ([f(vocab, h), r.randint(0, vocab, n)],
                         dict(padding_idx=1))
    c["normalize_op"] = ([f(n, h)], dict(p=2.0, axis=1, epsilon=1e-12))
    c["layer_norm_op"] = ([f(n, h), f(h), f(h)], dict(begin_axis=1,
                                                      epsilon=1e-5))
    c["rms_norm_op"] = ([f(n, h), f(h)], dict(epsilon=1e-6))
    c["batch_norm_train"] = ([f(n, h), f(h), f(h)], dict(axes_key=(0,),
                                                        epsilon=1e-5))
    c["batch_norm_infer"] = ([f(n, h), f(h), np.abs(f(h)) + 0.5, f(h),
                              f(h)], dict(ch_axis=1, epsilon=1e-5))
    # (16, 256, 4096) at full width: as many elements as (4096, 4096)
    gn, gc, groups = (16, 256, 32) if full else (2, 4, 2)
    c["group_norm_op"] = ([f(gn, gc, h), f(gc), f(gc)],
                          dict(groups=groups, epsilon=1e-5, nchw=True))
    c["instance_norm_op"] = ([f(gn, gc, h), f(gc), f(gc)],
                             dict(epsilon=1e-5))
    c["bce_logits"] = ([f(n, h), r.rand(n, h).astype(np.float32)], {})
    labels = r.randint(0, vocab, n).astype(np.int64)
    labels[::7] = -100                         # ignore_index rows
    c["softmax_ce"] = ([f(n, vocab), labels],
                       dict(axis=-1, soft_label=False, ignore_index=-100,
                            label_smoothing=0.1))
    # the sequence losses stay small: their lattices are a few steps long
    lp = np.log(r.rand(12, 3, 6).astype(np.float32) + 0.05)
    c["ctc_loss_op"] = ([lp, np.array([[1, 2, 2], [3, 1, 5], [4, 4, 1]],
                                      np.int32),
                         np.array([12, 10, 9], np.int32),
                         np.array([3, 2, 3], np.int32)], dict(blank=0))
    c["rnnt_loss_op"] = ([f(2, 5, 3, 6), np.array([[1, 3], [2, 0]],
                                                  np.int32),
                          np.array([5, 4], np.int32),
                          np.array([2, 1], np.int32)],
                         dict(blank=0, fastemit_lambda=0.001))
    return c


def model_op_cases():
    """The registry entries of the model's and the engine's plain
    functionals (no kernel behind them), at small shapes."""
    r = np.random.RandomState(SEED + 13)

    def f(*s):
        return r.randn(*s).astype(np.float32)

    c, hh = {}, 2
    c["sdpa"] = ([f(1, 64, hh, 16), f(1, 64, hh, 16), f(1, 64, hh, 16),
                  None], dict(scale=0.25, is_causal=True))
    cu = np.array([0, 20, 64], np.int32)
    c["varlen_sdpa"] = ([f(64, hh, 16), f(64, hh, 16), f(64, hh, 16), cu,
                         cu], dict(scale=0.25, causal=True))
    from paddle_tpu_torch.models.llama import _rope_tables
    cos, sin = (t.numpy() for t in _rope_tables(16, 64, 10000.0, "cpu"))
    c["rope"] = ([f(2, 64, hh, 16), cos, sin], {})
    c["rope_at"] = ([f(2, 8, hh, 16), cos, sin,
                     r.randint(0, 64, (2, 8)).astype(np.int32)], {})
    pages = (8, 4, 2, 16)
    sp = np.array([3, 3, 5, 1], np.int32)
    so = np.array([0, 1, 2, 3], np.int32)
    c["paged_kv_update"] = ([f(*pages), f(*pages), f(2, 2, 2, 16),
                             f(2, 2, 2, 16), sp, so], {})
    c["paged_kv_copy"] = ([f(*pages), f(*pages), np.array([3, 5], np.int32),
                           np.array([5, 7], np.int32)], {})
    codes = r.randint(-127, 128, pages).astype(np.int8)
    scl = (r.rand(8, 4, 2, 1) * 0.02).astype(np.float32)
    c["paged_kv_update_quant"] = ([codes, codes.copy(), scl, scl.copy(),
                                   f(2, 2, 2, 16), f(2, 2, 2, 16), sp, so],
                                  {})
    c["quant_embedding_lookup"] = ([r.randint(0, 8, (2, 5)).astype(np.int32),
                                    codes.reshape(8, -1), scl[:, 0, 0]], {})
    return c


# the registry entries over hand-written kernels: held to the kernel's
# plain version at phase 3's shapes, each launching its kernel once
KERNEL_OPS = ("flash_sdpa", "varlen_flash", "paged_attention",
              "paged_attention_quant", "quant_matmul")


RANDOM_OPS = ("uniform_op", "normal_op", "randint_op", "bernoulli_op",
              "poisson_op", "gamma_op", "dropout_op", "alpha_dropout_op",
              "sdpa_dropout", "varlen_sdpa_dropout")


def run_op_case(name, args, kwargs, device, grad=False):
    """One registry op on ``args`` (numpy) as tensors on ``device``; its
    outputs back on the CPU, then (``grad``) the gradients of the float
    outputs' sum with respect to each float input."""
    from paddle_tpu_torch.ops.op import apply
    targs = [None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device) for a in args]
    leaves = [t for t in targs if grad and t is not None
              and t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    out = apply(name, *targs, **kwargs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    res = [o.detach().cpu() for o in outs]
    # a seeded random cotangent an output (the same on both devices): the
    # plain sum's gradient vanishes for the norms and softmax, leaving
    # only rounding noise to compare
    g = torch.Generator().manual_seed(SEED + 5)
    terms = [(o.double() * torch.randn(o.shape, generator=g,
                                       dtype=torch.float64).to(o.device))
             .sum() for o in outs
             if o.is_floating_point() and o.requires_grad]
    if terms:
        sum(terms).backward()
        res += [torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
                for t in leaves]
    return res


def random_op_draw(name, device):
    """A random op's draw from a fresh generator of ``device`` seeded 5."""
    from paddle_tpu_torch.ops.op import apply
    g = torch.Generator(device=device)
    g.manual_seed(5)
    full = (lambda v: torch.full((64, 64), v, device=device))
    return {"uniform_op": lambda: apply("uniform_op", g, shape=(64, 64),
                                        dtype="float32", lo=-1.0, hi=1.0),
            "normal_op": lambda: apply("normal_op", g, 0.0, 1.0,
                                       shape=(64, 64), dtype="float32"),
            "randint_op": lambda: apply("randint_op", g, 0, 10,
                                        shape=(64, 64), dtype="int64"),
            "bernoulli_op": lambda: apply("bernoulli_op", g, full(0.3)),
            "poisson_op": lambda: apply("poisson_op", g, full(3.0)),
            "gamma_op": lambda: apply("gamma_op", g,
                                      torch.tensor(2.0, device=device),
                                      shape=(64, 64), dtype="float32"),
            "dropout_op": lambda: apply("dropout_op", full(1.0), g, p=0.3,
                                        upscale=True),
            "alpha_dropout_op": lambda: apply("alpha_dropout_op", full(1.0),
                                              g, p=0.3),
            "sdpa_dropout": lambda: apply(
                "sdpa_dropout", *[full(0.5).reshape(1, 64, 4, 16)] * 3,
                None, g, p=0.3, scale=0.25, is_causal=False).reshape(64, 64),
            "varlen_sdpa_dropout": lambda: apply(
                "varlen_sdpa_dropout", *[full(0.5).reshape(64, 4, 16)] * 3,
                *[torch.tensor([0, 30, 64], dtype=torch.int32,
                               device=device)] * 2, g, scale=0.25,
                causal=True, p=0.3).reshape(64, 64),
            }[name]()


def _ops_agree(name, got, want, scale_tol=None):
    """Card vs CPU outputs (and gradients): floats within OPS_RTOL and
    OPS_ATOL, or (an op of NN_TOL) OPS_RTOL and ``scale_tol`` x the
    tensor's largest magnitude; integers and bools exact; the largest
    float difference."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"op {name}: card {g.dtype} "
                                 f"{tuple(g.shape)}, CPU {w.dtype} "
                                 f"{tuple(w.shape)}")
        if g.is_floating_point() or g.is_complex():
            atol = OPS_ATOL if scale_tol is None or not w.numel() else \
                scale_tol * w.abs().max().item()
            if not torch.allclose(g, w, rtol=OPS_RTOL, atol=atol,
                                  equal_nan=True):
                raise AssertionError(f"op {name}: card and CPU differ "
                                     f"by {(g - w).abs().max():.3e}")
            fin = torch.isfinite(w) & torch.isfinite(g)
            if fin.any():
                worst = max(worst, (g - w)[fin].abs().max().item())
        elif not torch.equal(g, w):
            raise AssertionError(f"op {name}: card and CPU differ")
    return worst


def kernel_op_checks():
    """The registry entries over hand-written kernels on CUDA tensors at
    phase 3's shapes, each against its kernel's plain version on the same
    inputs to phase 3's tolerance, each launching its kernel once (a
    LAUNCH_COUNTS change of 1)."""
    from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda.attention import (
        ragged_paged_attention_decode_ref)
    from paddle_tpu_torch.ops.cuda.quant_matmul import quant_matmul_ref
    from paddle_tpu_torch.ops.op import apply
    bf16 = torch.bfloat16
    t = lambda x: x.transpose(1, 2)  # noqa: E731

    def launched(kernel, fn):
        before = LAUNCH_COUNTS[kernel]
        out = fn()
        torch.cuda.synchronize()
        if LAUNCH_COUNTS[kernel] != before + 1:
            raise AssertionError(f"{kernel}: {LAUNCH_COUNTS[kernel] - before}"
                                 f" launches by its registry entry")
        return out

    errs = {}
    # flash_sdpa at the training shape: B=1, H=32, S=4096, D=128, bf16
    q, k, v, _ = flash_inputs(1, 32, 32, 4096, 128, bf16, SEED + 20)
    out, lse = launched("flash_fwd", lambda: apply(
        "flash_sdpa", t(q), t(k), t(v), scale=128 ** -0.5, is_causal=True))
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, True)
    errs["flash_sdpa"] = flash_compare("flash_sdpa op", t(out), ro, bf16)
    if (lse[..., 0] - rl).abs().max() > 1e-5 * rl.abs().max() + 1e-5:
        raise AssertionError("flash_sdpa op: lse past 1e-5")
    # varlen_flash at the packed shape: T = 4096 in six documents
    q, k, v, _ = (x[0] for x in flash_inputs(1, 32, 32, 4096, 128, bf16,
                                             SEED + 21))     # (H, T, D)
    cu = cu_of(PACKED_DOCS)
    th = lambda x: x.transpose(0, 1)  # noqa: E731  (T, H, D) <-> (H, T, D)
    out, _ = launched("varlen_fwd", lambda: apply(
        "varlen_flash", th(q), th(k), th(v), cu, scale=128 ** -0.5,
        causal=True))
    ro, _ = fa.varlen_flash_fwd_ref(q, k, v, cu, True)
    errs["varlen_flash"] = flash_compare("varlen_flash op", th(out), ro,
                                         bf16)
    # the decode ops at the serving shape, bf16 pools and int8 pools
    q, kp, vp, bt, sl = rpa_inputs(8, 32, 32, 128, 16, 64, 2048, SERVE_LENS,
                                   bf16, SEED + 22)
    pos = (sl.long() - 1).clamp(min=0).to(torch.int32)[:, None]
    got = launched("rpa_decode", lambda: apply(
        "paged_attention", q[:, None], kp, vp, bt, sl, pos, scale=0.0,
        kernel=True))[:, 0]
    want = ragged_paged_attention_decode_ref(q, kp, vp, bt, sl)
    errs["paged_attention"] = (got.float() - want.float()).abs().max().item()
    atol, rtol = TOL[bf16]
    if bool(((got.float() - want.float()).abs() > atol + rtol *
             want.float().abs()).any()):
        raise AssertionError("paged_attention op disagrees with the plain "
                             "decode")
    (kq, ks), (vq, vs) = quant_pools(kp.float(), vp.float())
    got = launched("rpa_decode_quant", lambda: apply(
        "paged_attention_quant", q[:, None], kq, vq, ks, vs, bt, sl, pos,
        scale=0.0, kernel=True))[:, 0]
    want = ragged_paged_attention_decode_ref(q, kq, vq, bt, sl, None, ks, vs)
    errs["paged_attention_quant"] = (got.float() - want.float()).abs() \
        .max().item()
    if bool(((got.float() - want.float()).abs() > atol + rtol *
             want.float().abs()).any()):
        raise AssertionError("paged_attention_quant op disagrees with the "
                             "plain decode")
    # quant_matmul at the decode shape, int8 and int4, group 128
    for bits in (8, 4):
        (x, qw, sc, grp), _ = qmm_case(f"quant_matmul op int{bits}", 8,
                                       4096, 11008, bits, 128, bf16,
                                       SEED + 23, quiet=True)
        got = launched(f"qmm_i{bits}", lambda: apply(
            "quant_matmul", x, qw, sc, bits=bits, group=grp, kernel=True))
        want = quant_matmul_ref(x, qw, sc, bits=bits, group=grp)
        rel = ((got.float() - want.float()).norm() /
               want.float().norm()).item()
        if rel > QMM_REL_TOL[bf16]:
            raise AssertionError(f"quant_matmul op int{bits}: rel L2 {rel}")
        errs[f"quant_matmul int{bits}"] = (got.float() - want.float()) \
            .abs().max().item()
    return errs


def dropout_full_width():
    """The dropout ops at the flagship's width on the card: ``dropout_op``
    keeps at the reference's quantised rate (1 - round(p * 256) / 256,
    within 6 standard errors) and scales the kept values by its inverse,
    or at exactly 1 - p with the exact mask; ``alpha_dropout_op`` keeps a
    unit normal's mean and variance (within 0.01)."""
    from paddle_tpu_torch.ops.op import apply
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.ones(NN_FULL["rows"], NN_FULL["hidden"], device="cuda")
    for exact in (False, True):
        y = apply("dropout_op", x, g, p=0.1, upscale=True, exact=exact)
        keep = 0.9 if exact else 1 - round(0.1 * 256) / 256
        kept = y != 0
        rate = kept.double().mean().item()
        se = (keep * (1 - keep) / x.numel()) ** 0.5
        if abs(rate - keep) > 6 * se or not torch.equal(
                y[kept], torch.full_like(y[kept], 1 / keep)):
            raise AssertionError(f"dropout_op (exact {exact}): keep rate "
                                 f"{rate} against {keep}")
    a = apply("alpha_dropout_op", torch.randn(x.shape, generator=g,
                                              device="cuda"), g, p=0.1)
    if abs(a.mean().item()) > 0.01 or abs(a.var().item() - 1) > 0.01:
        raise AssertionError(f"alpha_dropout_op: mean {a.mean().item()}, "
                             f"variance {a.var().item()}")
    log(f"  dropout_op at {tuple(x.shape)}: keep rate {rate:.6f} (exact "
        f"mask; the quantised one checked too), alpha_dropout_op mean "
        f"{a.mean().item():.2e} variance {a.var().item():.4f}")


def extension_cases():
    """``tensor/extension.py``'s functions (not registry ops) on numpy
    inputs: (name, args, kwargs); lists of arrays go in as lists of
    tensors."""
    r = np.random.RandomState(SEED + 14)
    a = r.randn(64, 48).astype(np.float32)
    b = r.randn(40, 48).astype(np.float32)
    pos = (r.rand(64, 48) * 3 + 0.2).astype(np.float32)
    ints = r.randint(0, 50, 4096)
    x = np.array([0.0, 0.5, 1.5, 2.0, 4.0, 4.5, 6.0, 7.0, 9.0, 9.5]
                 + list(range(10, 48)), np.float32)
    return [
        ("unique", [ints], dict(return_index=True, return_inverse=True,
                                return_counts=True)),
        ("unique_consecutive", [np.sort(ints)],
         dict(return_inverse=True, return_counts=True)),
        ("argwhere", [a > 1.0], {}),
        ("take", [a, r.randint(-3000, 3000, (32, 8))], {}),
        ("take", [a, r.randint(-9000, 9000, 64)], dict(mode="wrap")),
        ("block_diag", [[a[:8], b[:5, :7], a[0]]], {}),
        ("cartesian_prod", [[np.arange(5), np.arange(7)]], {}),
        ("cdist", [a, b], {}), ("cdist", [a, b], dict(p=1.0)),
        ("trapezoid", [a, x], {}),
        ("cumulative_trapezoid", [a], dict(dx=0.25, axis=0)),
        ("renorm", [a, 2.0, 0, 5.0], {}),
        ("multigammaln", [pos + 2.0, 3], {}),
        ("polygamma", [pos, 1], {}),
        ("sinc", [a], {}), ("signbit", [a], {}), ("copysign", [a, pos], {}),
        ("gammaln", [pos], {}), ("gammainc", [pos, pos[::-1].copy()], {}),
        ("gammaincc", [pos, pos[::-1].copy()], {}),
        ("i0", [a], {}), ("i1", [a], {}), ("i0e", [a], {}),
        ("i1e", [a], {}),
        ("isneginf", [np.array([-np.inf, 0.0, np.inf], np.float32)], {}),
        ("isposinf", [np.array([-np.inf, 0.0, np.inf], np.float32)], {}),
        ("logaddexp", [a, pos], {}), ("logaddexp2", [a, pos], {}),
        ("nextafter", [a, pos], {}), ("frexp", [a * 100], {}),
        ("slice_scatter", [a, np.zeros((64, 12), np.float32), [1], [0],
                           [48], [4]], {}),
        ("index_fill", [a, np.array([0, 5, 9]), 1, -2.0], {}),
        ("column_stack", [[a[:, 0], a]], {}), ("vstack", [[a, b]], {}),
        ("hstack", [[a, pos]], {}), ("dstack", [[a, pos]], {}),
        ("addmm", [np.ones((64, 40), np.float32), a, b.T.copy()],
         dict(beta=0.5, alpha=2.0)),
        ("pdist", [b], {}), ("sgn", [a], {}),
        ("unflatten", [a, 1, [6, 8]], {}),
        ("diagonal_scatter", [a[:48], np.ones(48, np.float32)], {}),
        ("as_complex", [a.reshape(64, 24, 2).copy()], {}),
        ("as_real", [(a[:, :24] + 1j * a[:, 24:]).astype(np.complex64)],
         {}),
        ("shard_index", [r.randint(0, 1000, (256, 1))],
         dict(index_num=1000, nshards=4, shard_id=2)),
    ]


def run_extension_case(name, args, kwargs, device):
    import paddle_tpu_torch as P

    def conv(v):
        if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            return [conv(u) for u in v]
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(v)).to(device)
        return v
    out = getattr(P, name)(*[conv(v) for v in args], **kwargs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o.detach().cpu() for o in outs]


def phase_ops(card):
    """Every op of the port's registry on CUDA tensors against the same
    call on CPU tensors: float32 within OPS_RTOL/OPS_ATOL (an nn op that
    sums thousands of terms within its NN_TOL), integer and bool outputs
    exact; the nn ops at the flagship's width (NN_FULL), their gradients
    too; each random op's draws on the card reproduce under the same seed
    and have the right shape and dtype; the registry entries over the
    hand-written kernels against the kernels' plain versions at phase 3's
    shapes, each launching its kernel."""
    from paddle_tpu_torch.ops.op import all_ops
    import paddle_tpu_torch.nn.functional as F
    log("[11/12] ops: the registry on the card vs the CPU")
    t0 = time.perf_counter()
    cases = op_cases(full=True)
    nn_names = set(nn_op_cases(False))
    names = set(all_ops())
    covered = set(cases) | set(RANDOM_OPS) | set(KERNEL_OPS)
    if covered != names:
        raise AssertionError(f"ops without a case: {sorted(names - covered)}"
                             f", cases of no op: {sorted(covered - names)}")
    worst, nn_worst = 0.0, {}
    for name in sorted(cases):
        args, kwargs = cases[name]
        grad = name in nn_names
        got = run_op_case(name, args, kwargs, "cuda", grad)
        want = run_op_case(name, args, kwargs, "cpu", grad)
        if grad:
            # each output's and gradient's largest difference, as a
            # fraction of its largest magnitude, then the check
            nn_worst[name] = [
                (g - w).abs().max().item() / max(w.abs().max().item(),
                                                 1e-30)
                if g.is_floating_point() and g.shape == w.shape and
                g.numel() else 0.0 for g, w in zip(got, want)]
            log(f"    {name}: max |card - CPU| / max |CPU|, outputs then "
                f"grads: {['%.2e' % e for e in nn_worst[name]]}"
                + (f" (bound OPS_RTOL + {NN_TOL[name]:g} x max)"
                   if name in NN_TOL else ""))
            _ops_agree(name, got, want, NN_TOL.get(name))
        else:
            worst = max(worst, _ops_agree(name, got, want))
    log(f"  {len(cases) - len(nn_names)} ops agree card vs CPU (largest "
        f"float difference {worst:.3e})")
    log(f"  {len(nn_names)} nn ops at {NN_FULL} (forward and gradients) "
        f"agree card vs CPU")
    # cross_entropy at (4096, 32000) with class weights, ignore_index rows
    # and label smoothing, forward and backward, card vs CPU
    r = np.random.RandomState(SEED + 12)
    logits = r.randn(NN_FULL["rows"], NN_FULL["vocab"]).astype(np.float32)
    labels = r.randint(0, NN_FULL["vocab"], NN_FULL["rows"])
    labels[::7] = -100
    weight = (r.rand(NN_FULL["vocab"]) + 0.5).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        x = torch.from_numpy(logits).to(dev).requires_grad_(True)
        loss = F.cross_entropy(x, torch.from_numpy(labels).to(dev),
                               weight=torch.from_numpy(weight).to(dev),
                               label_smoothing=0.1)
        loss.backward()
        res[dev] = [loss.detach().cpu(), x.grad.cpu()]
    err = _ops_agree("cross_entropy(weight, ignore_index, label_smoothing)",
                     res["cuda"], res["cpu"], NN_TOL["softmax_ce"])
    log(f"  cross_entropy at (4096, 32000), weight + ignore_index + "
        f"smoothing 0.1: loss {res['cuda'][0].item():.6f}, card vs CPU "
        f"(loss and grad) {err:.3e}")
    dropout_full_width()
    for name in RANDOM_OPS:
        a, b = random_op_draw(name, "cuda"), random_op_draw(name, "cuda")
        if a.shape != (64, 64) or a.device.type != "cuda" or \
                not torch.equal(a, b):
            raise AssertionError(f"random op {name}: {a.dtype} "
                                 f"{tuple(a.shape)} on {a.device}, "
                                 f"reproducible {torch.equal(a, b)}")
    ext = extension_cases()
    ext_worst = max(_ops_agree(name, run_extension_case(name, a, k, "cuda"),
                               run_extension_case(name, a, k, "cpu"))
                    for name, a, k in ext)
    log(f"  {len(ext)} calls of {len({c[0] for c in ext})} tensor/extension"
        f".py functions agree card vs CPU (largest float difference "
        f"{ext_worst:.3e})")
    errs = kernel_op_checks()
    log(f"  {len(KERNEL_OPS)} kernel entries at phase 3's shapes, each one "
        f"launch of its kernel, max abs err vs the plain version: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    log(f"  {len(RANDOM_OPS)} random ops reproduce under their generator's "
        f"seed; {time.perf_counter() - t0:.1f} s")


# -- phase 12: the nn surface and checkpoints -------------------------------------

# the model built only from the nn surface, at Llama-7B's MLP width, and its
# batch: (8, 512, 4096) f32
NN_MODEL_BATCH = (8, 512, 4096)
# card vs CPU, the nn-surface model's first step with dropout off: the
# loss within 1e-4 relative, every gradient within 1e-4 relative L2 (f32
# matmuls in full f32 on both sides, summed in another order)
NN_PARITY_RTOL = 1e-4


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as int16 words (bf16 and f16) or as itself."""
    return t.view(torch.int16) if t.element_size() == 2 else t


def flagship_round_trip(card):
    """(a) Llama-7B (32 layers, bf16) saved with ``paddle_tpu_torch.save``
    in the reference's checkpoint format, loaded with ``load`` into a
    second Llama-7B built from another seed after the first is freed:
    every tensor bitwise equal, phase 4's prompts give the same greedy
    tokens and the same first-decode-step logits, bitwise."""
    import shutil
    import tempfile
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config)
    from paddle_tpu_torch.serving.engine import ServingEngine
    cfg = llama_7b_config()
    prompts = serve_prompts(SEED, cfg.vocab_size)
    cmp_prompts = compare_prompts(cfg.vocab_size)

    def serve(model):
        engine = ServingEngine(model, num_blocks=2048, **SERVE_KW)
        logits = first_decode_logits(engine, cmp_prompts, 4)
        tokens = engine.generate(prompts, max_new_tokens=8)
        del engine
        return logits, tokens

    model = LlamaForCausalLM(cfg, seed=SEED)
    logits, tokens = serve(model)
    nbytes = sum(t.numel() * t.element_size()
                 for t in model.state_dict().values())
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        if free < 2 * nbytes:
            raise RuntimeError(f"the temporary directory {tmp} has "
                               f"{free / 1e9:.2f} GB free; the round trip "
                               f"needs twice the checkpoint's "
                               f"{nbytes / 1e9:.2f} GB")
        path = str(Path(tmp) / "llama7b.pdparams")
        t0 = time.perf_counter()
        P.save(model.state_dict(), path)
        save_s = time.perf_counter() - t0
        file_gb = Path(path).stat().st_size / 1e9
        host = {k: _bits(v.detach()).cpu()
                for k, v in model.state_dict().items()}
        probe = model.llama.embed_tokens.weight[:4].detach().clone()
        del model
        free_cuda()
        second = LlamaForCausalLM(cfg, seed=SEED + 1)
        if torch.equal(second.llama.embed_tokens.weight[:4], probe):
            raise AssertionError("the second model starts with the first's "
                                 "weights")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = P.load(path)
        missing, unexpected = second.set_state_dict(loaded)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del loaded
    if missing or unexpected:
        raise AssertionError(f"missing {missing}, unexpected {unexpected}")
    bad = [k for k, v in second.state_dict().items()
           if not torch.equal(_bits(v.detach()).cpu(), host[k])]
    if bad or len(host) != len(second.state_dict()):
        raise AssertionError(f"{len(bad)} tensors differ after the round "
                             f"trip: {bad[:4]}")
    logits2, tokens2 = serve(second)
    same_logits = torch.equal(logits, logits2)
    log(f"  [{card}] Llama-7B round trip: {len(host)} tensors, "
        f"{nbytes / 1e9:.3f} GB, file {file_gb:.3f} GB; save "
        f"{save_s:.2f} s, load + set_state_dict {load_s:.2f} s; every "
        f"tensor bitwise equal; greedy tokens of phase 4's "
        f"{len(prompts)} prompts equal {tokens2 == tokens}; first decode "
        f"step logits bitwise equal {same_logits}")
    if tokens2 != tokens or not same_logits:
        raise AssertionError("the loaded model serves differently")
    del second, host
    free_cuda()
    return {"save_s": save_s, "load_s": load_s, "file_gb": file_gb}


def nn_surface_model(device, seed):
    from paddle_tpu_torch import nn
    g = torch.Generator(device=device).manual_seed(seed)
    h, inter = NN_MODEL_BATCH[2], 11008
    kw = dict(device=device, generator=g)
    return nn.Sequential(nn.Linear(h, inter, **kw), nn.GELU(),
                         nn.Dropout(0.1), nn.Linear(inter, h, **kw),
                         nn.LayerNorm(h, **kw))


def nn_surface_training(card):
    """(b) A model built only from the nn surface at Llama-7B's MLP width
    takes 3 AdamW steps with ``clip_grad_norm_(1.0)`` on (8, 512, 4096)
    f32 inputs: losses finite and falling; with dropout off, the card's
    first-step loss and gradients equal the CPU's within NN_PARITY_RTOL."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn(NN_MODEL_BATCH, generator=g)
    target = torch.randn(NN_MODEL_BATCH, generator=g)
    model = nn_surface_model("cuda", SEED)
    cpu_model = nn_surface_model("cpu", SEED + 1)
    cpu_model.set_state_dict(model.state_dict())
    grads = {}
    for name, m in (("card", model), ("cpu", cpu_model)):
        m.eval()
        dev = next(iter(m.parameters())).device
        loss = F.mse_loss(m(x.to(dev)), target.to(dev))
        loss.backward()
        grads[name] = (loss.item(), {n: p.grad.cpu() for n, p in
                                     m.named_parameters()})
        m.clear_gradients()
    loss_rel = abs(grads["card"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
    grad_rel = max(((grads["card"][1][n] - w).norm() / w.norm()).item()
                   for n, w in grads["cpu"][1].items())
    del cpu_model
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    xs, ts = x.cuda(), target.cuda()
    losses, norms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        loss = F.mse_loss(model(xs), ts)
        loss.backward()
        norms.append(nn.clip_grad_norm_(model.parameters(), 1.0).item())
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    step_s = (time.perf_counter() - t0) / 3
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  [{card}] nn-surface model (Sequential: Linear 4096x11008, GELU, "
        f"Dropout 0.1, Linear 11008x4096, LayerNorm; {n_params / 1e6:.1f} M "
        f"parameters) on {NN_MODEL_BATCH} f32: dropout off, card vs CPU "
        f"first-step loss {loss_rel:.3e}, gradients {grad_rel:.3e} (tol "
        f"{NN_PARITY_RTOL}); 3 AdamW steps with clip_grad_norm_(1.0): "
        f"losses {losses}, gradient norms before the clip {norms}, "
        f"{step_s * 1e3:.1f} ms a step")
    if not (loss_rel <= NN_PARITY_RTOL and grad_rel <= NN_PARITY_RTOL):
        raise AssertionError("the nn-surface model's card and CPU steps "
                             "differ")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"nn-surface losses not finite and falling: "
                             f"{losses}")
    del model, opt
    free_cuda()


def phase_nn(card):
    log("[12/12] nn surface and checkpoints, at full width")
    t0 = time.perf_counter()
    out = flagship_round_trip(card)
    nn_surface_training(card)
    log(f"  {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log("[1/12] device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    card = smi
    bw, bw_key = peak_bw(name)
    log(f"  {name}; {count} device(s); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peak bandwidth {bw / 1e12:.2f} TB/s "
        f"({bw_key})")
    log(smi)

    log("[2/12] build")
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for kname, info in built.items():
        build_report(kname, info)

    log("[3/12] kernel vs plain version")
    rows = [phase_kernel(card, bw)] + phase_flash_kernels(card, bw) + \
        phase_varlen_kernels(card, bw) + phase_quant_kernels(card, bw) + \
        [phase_fused_update(card, bw)]
    phase_decode_shapes(card, bw)
    phase_wide_heads(card)
    launches = {"rpa_decode": phase_serve(card)["rpa_decode"]}
    launches.update({n: v for n, v in phase_train(
        card, PEAK_OPS[torch.bfloat16]).items()
        if n.startswith("flash_") or n == "fused_update"})
    launches.update({n: v for n, v in phase_packed(card).items()
                     if n.startswith("varlen_")})
    phase_train_parity()
    launches.update(phase_quant_serve(card))
    phase_amp(card, PEAK_OPS[torch.float16])
    phase_profiles(card)
    phase_ops(card)
    phase_nn(card)
    # on the captured paths: each graph's launches a replay (checked
    # against the profiler in phase 10) times its replays
    launched_in = {"rpa_decode": "captured serve (phase 4)",
                   "flash_fwd": "captured train (phase 5)",
                   "flash_dq": "captured train (phase 5)",
                   "flash_dkv": "captured train (phase 5)",
                   "flash_bwd_delta": "captured train (phase 5)",
                   "fused_update": "captured train (phase 5)",
                   "qmm_i8": "captured quantized serve (phase 8)",
                   "qmm_i4": "captured quantized serve (phase 8)",
                   "rpa_decode_quant": "captured quantized serve (phase 8)"}
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
