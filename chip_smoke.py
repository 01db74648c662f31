#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device — the card's name, count, and ``nvidia-smi`` name/power limit;
2. build  — nvcc compiles every kernel source of the package (sm_90a);
3. kernel — each kernel against its plain PyTorch version on the same
   inputs at the serving path's shapes, plus edge cases; kernel, plain and
   library times with CUDA events (L2 flushed between launches) and the
   card's bound for the same work;
4. serve  — Llama-7B at full width and depth (random weights from a seed,
   bf16) behind ``ServingEngine``: 10 greedy requests, launch counts read
   around the run, first-decode-step logits held against an engine on the
   plain gather path, and a tiny f32 model's tokens held against a
   full-recompute greedy reference; a torch.profiler breakdown of
   batch-8 decode steps says where a step's time goes.

The second-to-last stdout line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
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
# Peak device-memory bandwidth (bytes/s) and dense rates (ops/s) by card,
# NVIDIA data sheets (SXM parts unless named).
PEAK_BW = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
           ("H100", 3.35e12))
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}


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
    96 MB write between calls so every call finds the 50 MB L2 cold."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# -- phase 3: kernel vs plain ----------------------------------------------

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


def rpa_bound_ms(q, k, lens, page, bw):
    """Least time for the work these inputs need: every K/V row of the
    valid tokens, q, the output and the used table entries moved once, or
    the QK and PV multiply-adds at the input type's dense peak."""
    b, h, d = q.shape
    hkv, el = k.shape[2], k.element_size()
    tokens = int(sum(lens))
    nbytes = (2 * tokens * hkv * d * el + 2 * b * h * d * el
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
    log("[3/4] kernel vs plain version")
    bf16 = torch.bfloat16
    # the serving phase's decode shape: B=8, H=Hkv=32, D=128, page 16,
    # 2048 pages, tables 64 wide (max_seq_len 1024); ragged lengths with an
    # inert row, length 1, lengths at and past a page boundary, a full table
    serve_lens = [0, 1, 16, 17, 127, 300, 640, 1024]
    main = rpa_case("serving shape, MHA", 8, 32, 32, 128, 16, 64, 2048,
                    serve_lens, bf16, SEED)
    rpa_case("GQA 32q/8kv", 8, 32, 8, 128, 16, 64, 2048, serve_lens, bf16,
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
    bound_ms, bound_by = rpa_bound_ms(q, k, serve_lens, k.shape[1], bw)
    log(f"  timing at the serving shape ({card}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (SDPA on pre-gathered dense "
        f"K/V, gather excluded) {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms by {bound_by}")
    return {"name": "rpa_decode", "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda/csrc/rpa_decode.cu",
            "replaces": "paddle_tpu/ops/pallas/attention.py:885",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def profile_decode(engine, prompts, card, steps: int = 6) -> None:
    """Where a full decode step's time goes: host wall time of ``steps``
    steps at batch 8 without and then with torch.profiler, device time by
    kernel name, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.scheduler import RUNNING
    reqs = [engine.submit(p[:64], 4 * steps) for p in prompts[:8]]
    while any(r.state != RUNNING for r in reqs):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        assert engine.step() == "decode"
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            assert engine.step() == "decode"
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    # kernels only: an operator row also carries its kernels' device time
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    log(f"  [{card}] decode step at batch 8: {plain_ms:.3f} ms host wall "
        f"unprofiled, {wall_ms:.3f} ms profiled; device busy "
        f"{device_ms:.3f} ms a step ({device_ms / wall_ms:.1%} of the "
        f"profiled wall), {launches:.0f} kernel launches a step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / steps:9.3f} ms/step "
            f"{e.count / steps:6.0f}x  {e.key[:90]}")
    for r in reqs:
        engine.cancel(r.rid)


def phase_serve(card):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_7b_config,
                                               llama_tiny_config)
    from paddle_tpu_torch.ops.cuda.attention import (LAUNCH_COUNTS,
                                                     reset_launch_counts)
    from paddle_tpu_torch.serving.engine import ServingEngine
    log("[4/4] serve Llama-7B (full width and depth, bf16, random weights)")
    t0 = time.perf_counter()
    cfg = llama_7b_config()
    model = LlamaForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    log(f"  model: {model.num_params() / 1e9:.3f} B parameters, "
        f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"intermediate {cfg.intermediate_size}, heads "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}, vocab "
        f"{cfg.vocab_size}, built in {time.perf_counter() - t0:.1f} s")
    kw = dict(block_size=16, max_batch=8, prefill_chunk=256,
              max_seq_len=1024)
    engine = ServingEngine(model, num_blocks=2048, **kw)
    assert engine._use_kernel, "the engine on the card must use the kernel"
    log(f"  KV pool {engine.kv.pool_bytes() / 1e9:.2f} GB "
        f"({engine.kv.num_blocks} pages of {engine.kv.block_size})")
    engine.warmup()
    prompts = serve_prompts(SEED, cfg.vocab_size)
    new_tokens = 32
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
    expect = stats["decode_steps"] * cfg.num_hidden_layers
    assert launches["rpa_decode"] == expect > 0, (launches, expect)
    ttft = np.array([(r.first_token_at - r.submitted_at) * 1e3
                     for r in reqs])
    toks = sum(len(o) for o in outs)
    log(f"  served {len(outs)} requests x {new_tokens} tokens; prefix "
        f"cache: {prefix['hits']} hits, {prefix['hit_tokens_total']} hit "
        f"tokens, {prefix['cow_copies_total']} copy-on-write")
    log(f"  rpa_decode launches {launches['rpa_decode']} = "
        f"{stats['decode_steps']} decode steps x {cfg.num_hidden_layers} "
        f"layers")
    log(f"  [{card}] tokens/s {toks / wall:.1f} ({toks} tokens in "
        f"{wall:.3f} s); TTFT ms mean {ttft.mean():.2f} p50 "
        f"{np.median(ttft):.2f} max {ttft.max():.2f}; decode step ms "
        f"{stats['decode_seconds'] / stats['decode_steps'] * 1e3:.3f}; "
        f"prefill step ms "
        f"{stats['prefill_seconds'] / stats['prefill_steps'] * 1e3:.3f}; "
        f"peak memory {peak / 1e9:.2f} GB")

    # first decode step of the kernel engine vs an engine on the plain
    # gather path, same weights and prompts
    rng = np.random.default_rng(SEED + 1)
    cmp_prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
                   for n in (20, 57, 96, 128)]
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
    del plain
    profile_decode(engine, prompts, card)
    del engine, model
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log("[1/4] device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    card = smi
    bw, bw_key = peak_bw(name)
    log(f"  {name}; {count} device(s); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peak bandwidth {bw / 1e12:.2f} TB/s "
        f"({bw_key})")
    log(smi)

    log("[2/4] build")
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for kname, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    row = phase_kernel(card, bw)
    launches = phase_serve(card)
    row["launches"] = launches[row["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [row]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
