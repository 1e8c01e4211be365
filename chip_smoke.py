#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together) and print the build time;
3. kernel phase: the paged-decode kernel (K4) against
   ``paged_attention_reference`` on the card, over bf16 / fp32 / int8
   pools, MHA (H = Hkv = 16) and GQA (H = 16, Hkv = 4), head dims 128 and
   64, page size 16, ragged lengths up to 1024 including an inactive row
   (length 0), and a poisoned NULL page; then its time at the serving
   path's shapes beside the plain version's, ``scaled_dot_product_attention``
   on the gathered view (a yardstick the port never calls) and the bound;
4. serving phase, the port's main path: ``InferenceEngine`` over the
   widest TransformerLM the repo benchmarks (vocab 32768, d_model 2048,
   6 layers, 16 heads, d_ff 8192; bf16 compute, random weights from a
   seed), 16 greedy requests with seeded prompt lengths 64..512 (half of
   them share a 128-token prefix) and 64 new tokens each, ``max_slots=8``,
   ``max_seq_len=1024``, ``page_size=16``; fp pages, then int8 pages. Every
   request must finish, K4 must have launched once per layer of every
   decode step, and for two requests the teacher-forced decode logits of
   the kernel path must match the plain path's;
5. flash kernel phase: the flash-attention forward (K1: out and lse) and
   backward (K2: dQ, K3: dK and dV) against their plain versions on the
   card, over fp32 and bf16, head dims 64 and 128, non-causal, causal,
   window 256 and window 256 with q_offset 300 (rows wholly masked),
   T in {1, 100, 1000, 1024} (tail tiles, no dense fallback), B*H up to
   32, plus the ``with_lse`` backward with a nonzero lse cotangent; then
   each kernel's time at the training path's shapes (B=2, H=16, T=8192,
   D=128, causal, bf16) beside the plain version's (run four heads at a
   time so it fits), ``scaled_dot_product_attention`` (forward, and its
   backward as forward+backward minus forward; a yardstick the port never
   calls) and the bound;
6. training phase, the port's second main path: ``Trainer`` over the same
   full-width TransformerLM with float32 parameters and bf16 compute,
   ``Adam(lr=1e-4)``, softmax cross-entropy, 8 seeded random sequences of
   8192 tokens at batch 2 (4 steps an epoch), ``save_every=1`` into a
   snapshot in a temporary directory: epoch 0, then a fresh Trainer on the
   same snapshot must resume at epoch 1 and step 4 and run epoch 1. K1, K2
   and K3 must each have launched n_layers x steps times; every loss must
   be finite and the epoch-0 loss near a random model's;
7. one training step at T=1024 through the kernels and through the plain
   attention, from the same weights and batch: loss and per-parameter
   gradient norms must agree; the same step through three planted faults
   of the plain attention (no causal mask, dK zeroed, dK off by 5%) must
   fail those limits;
8. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
   as the last line.

Exits nonzero, printing no result, when no CUDA device is visible or the
port is not importable from this directory.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
PAGE = 16
MAX_SLOTS = 8
MAX_SEQ_LEN = 1024
PAGES_PER_SEQ = MAX_SEQ_LEN // PAGE
NUM_PAGES = MAX_SLOTS * PAGES_PER_SEQ + 1
MODEL = dict(vocab_size=32768, d_model=2048, n_layers=6, n_heads=16, d_ff=8192)
N_REQUESTS = 16
NEW_TOKENS = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

# Kernel vs plain version, (atol, rtol): |got - ref| <= atol + rtol * |ref|
# everywhere. fp32: both sum in fp32 in another order. bf16: the plain
# version rounds scores and the weighted sum through bf16 where the kernel
# keeps fp32, ~2^-8 relative. The same holds for int8 pages read with a
# bf16 query (dequantized in bf16 by the plain version, in fp32 by the
# kernel).
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# Flash kernels vs their plain versions, which round where the kernels
# round. fp32, element by element: sums in another order. bf16, row by row
# (RMS over the head dim): the fp32 sums differ in their last bits, which
# now and then flips the bf16 rounding of one probability (or dS) and moves
# its row by up to 2^-8 of that term, however small the element is after
# cancellation; a row's RMS error stays well under 1% of the row's RMS.
# lse is float32 on both sides whatever q's dtype, element by element.
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 1e-2)}
LSE_TOL = (1e-5, 1e-5)
# The with_lse backward (fp32) against autograd through the plain forward:
# the same gradient by two algorithms, ~1e-6 apart.
WITH_LSE_TOL = 1e-4
# Training path: the full-width model at the repo's LM benchmark shapes.
TRAIN_T = 8192
TRAIN_BATCH = 2
TRAIN_SEQS = 8
TRAIN_LR = 1e-4
# A random model's cross-entropy with this init: the LM head's lecun-normal
# kernel over LayerNorm-ed features gives unit-variance logits, so the loss
# starts at ln V + 1/2 (10.897), and 4 steps of Adam at 1e-4 move it little.
LOSS_START = math.log(MODEL["vocab_size"]) + 0.5
LOSS_BAND = 0.5
# Kernel path vs plain attention, one training step at T=1024 of the bf16
# model: attention outputs differ by bf16 rounding in 6 layers (measured on
# an H100 SXM at 700 W: loss 1.6e-4, gradient norms 8.0e-4 relative). The
# same step through planted faults of the plain attention (FAULTS) must
# fail these limits, or the check is void.
STEP_LOSS_TOL = 2e-3
STEP_GRAD_RTOL = 1e-2
# Controls: no causal mask (a forward fault), dK zeroed and dK off by 5%
# (backward faults).
FAULTS = ("no_causal_mask", "dk_zero", "dk_5pct")
CHECK_T = 1024
# Teacher-forced logits, kernel path vs plain path, bf16 model: the
# attention outputs differ by bf16 rounding in each of 6 layers and the
# difference reaches the logits (scale ~5 here; 0.039 measured on an H100
# SXM at 700 W), where a wrong kernel moves them by O(1).
LOGIT_TOL = 0.1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def limit_used(out: torch.Tensor, ref: torch.Tensor, tol, per_row: bool = False) -> float:
    """The largest |out - ref| / (atol + rtol * |ref|): the share of the
    limit ``tol = (atol, rtol)`` that the worst element uses; with
    ``per_row``, the worst row's, from RMS values over the last dim."""
    atol, rtol = tol
    diff, ref = (out.float() - ref.float()).abs(), ref.float().abs()
    if per_row:
        diff, ref = diff.square().mean(-1).sqrt(), ref.square().mean(-1).sqrt()
    return (diff / (atol + rtol * ref)).max().item()


def agrees(out: torch.Tensor, ref: torch.Tensor, tol) -> bool:
    """|out - ref| <= atol + rtol * |ref| everywhere: a bf16 result may be a
    rounding step off, and that step grows with the value."""
    return limit_used(out, ref, tol) <= 1.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return out


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after overwriting a buffer larger than the 50 MB L2, so
    every launch finds its inputs in device memory as a decode step does
    (the other layers' pools and the weights pass through L2 in between)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def paged_problem(gen, *, h, kv_heads, d, dtype, quant, lens, device):
    """A decode batch over pools of the serving geometry: random pages in
    random physical order, table tails on the NULL page."""
    from distributed_pytorch_tpu_torch.ops.quant import quantize_int8

    s = len(lens)
    q = torch.randn(s, 1, h, d, generator=gen, device=device).to(dtype)
    shape = (NUM_PAGES, PAGE, kv_heads, d)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    kw = {}
    if quant:
        kq, vq = quantize_int8(k, (3,)), quantize_int8(v, (3,))
        k, v = kq.q, vq.q
        kw = dict(k_scale=kq.scale.squeeze(-1), v_scale=vq.scale.squeeze(-1))
    else:
        k, v = k.to(dtype), v.to(dtype)
    order = torch.randperm(NUM_PAGES - 1, generator=gen, device=device) + 1
    tables = torch.zeros(s, PAGES_PER_SEQ, dtype=torch.int32, device=device)
    for i, n in enumerate(lens):
        used = n // PAGE + 1
        tables[i, :used] = order[i * PAGES_PER_SEQ : i * PAGES_PER_SEQ + used].int()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k, v, tables, lens_t, kw


def kernel_phase(device) -> dict:
    from distributed_pytorch_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    lens = [0, 1, 15, 16, 17, 500, 1000, 1023]
    cases = [
        ("bf16 mha d128", 16, 16, 128, torch.bfloat16, False),
        ("fp32 mha d128", 16, 16, 128, torch.float32, False),
        ("bf16 gqa d128", 16, 4, 128, torch.bfloat16, False),
        ("fp32 gqa d64", 16, 4, 64, torch.float32, False),
        ("int8 pages bf16 mha d128", 16, 16, 128, torch.bfloat16, True),
        ("int8 pages fp32 gqa d64", 16, 4, 64, torch.float32, True),
        ("bf16 mha d64", 16, 16, 64, torch.bfloat16, False),
    ]
    for name, h, kv_heads, d, dtype, quant in cases:
        q, k, v, tables, lens_t, kw = paged_problem(
            gen, h=h, kv_heads=kv_heads, d=d, dtype=dtype, quant=quant,
            lens=lens, device=device,
        )
        out = paged_attention(q, k, v, tables, lens_t, **kw)
        ref = paged_attention_reference(q, k, v, tables, lens_t, **kw)
        # Poison the NULL page: live rows must not move by a single bit,
        # the inactive row (len 0, reads key 0 of page 0) must stay finite.
        k0, v0 = k[0].clone(), v[0].clone()
        k[0], v[0] = (127, -127) if quant else (1e4, -1e4)
        poisoned = paged_attention(q, k, v, tables, lens_t, **kw)
        k[0], v[0] = k0, v0
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = KERNEL_TOL[dtype]
        live = torch.tensor(lens, device=device) > 0
        print(f"kernel {name}: max_abs_err {err:.3e} "
              f"(tol {tol[0]:.0e} abs + {tol[1]:.0e} rel)", flush=True)
        if not torch.isfinite(out).all() or not torch.isfinite(poisoned).all():
            fail(f"kernel {name}: non-finite output")
        if not agrees(out, ref, tol):
            fail(f"kernel {name}: max_abs_err {err} beyond {tol} (abs, rel)")
        if not torch.equal(poisoned[live], out[live]):
            fail(f"kernel {name}: a poisoned NULL page moved a live row")

    # Time at the serving path's shapes: 8 slots, 16 heads of 128, bf16
    # pools of 513 pages, lengths as the serving phase's requests reach.
    rng = np.random.default_rng(SEED)
    main_lens = rng.integers(64, 512 + NEW_TOKENS + 1, MAX_SLOTS).tolist()
    h, kv_heads, d = MODEL["n_heads"], MODEL["n_heads"], MODEL["d_model"] // MODEL["n_heads"]
    q, k, v, tables, lens_t, _ = paged_problem(
        gen, h=h, kv_heads=kv_heads, d=d, dtype=torch.bfloat16, quant=False,
        lens=main_lens, device=device,
    )
    out = paged_attention(q, k, v, tables, lens_t)
    ref = paged_attention_reference(q, k, v, tables, lens_t)
    err = (out.float() - ref.float()).abs().max().item()
    if not agrees(out, ref, KERNEL_TOL[torch.bfloat16]):
        fail(f"kernel at serving shapes: max_abs_err {err}")
    # SDPA on the pre-gathered logical view (the gather is not timed).
    kv_len = PAGES_PER_SEQ * PAGE
    keys = k[tables.long()].reshape(MAX_SLOTS, kv_len, kv_heads, d).transpose(1, 2)
    values = v[tables.long()].reshape(MAX_SLOTS, kv_len, kv_heads, d).transpose(1, 2)
    mask = (torch.arange(kv_len, device=device)[None, :] <= lens_t[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q.transpose(1, 2)  # [S, H, 1, D]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)  # 256 MB
    iters = 200
    ms = time_ms(lambda: paged_attention(q, k, v, tables, lens_t), iters, flush)
    plain_ms = time_ms(lambda: paged_attention_reference(q, k, v, tables, lens_t), 50, flush)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, keys, values, attn_mask=mask
        ),
        iters, flush,
    )
    # The least the card could take: every key and value the rows need
    # (positions 0..pos) read once, q read and out written once, the used
    # table entries and lengths read once; the flops (4 * D per key per
    # query head) over the bf16 peak.
    keys_needed = sum(n + 1 for n in main_lens)
    pages_needed = sum(n // PAGE + 1 for n in main_lens)
    elt = 2  # bf16
    nbytes = (
        2 * keys_needed * kv_heads * d * elt
        + 2 * MAX_SLOTS * h * d * elt
        + 4 * (pages_needed + MAX_SLOTS)
    )
    flops = 4 * d * h * keys_needed
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"kernel timing (8 slots, lens {main_lens}, bf16, H=Hkv=16, D=128): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa on gathered view "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({nbytes} B / 3.35 TB/s; "
        f"{flops} flop / 989 TFLOP/s = {ops_ms:.6f} ms)",
        flush=True,
    )
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def make_requests():
    rng = np.random.default_rng(SEED)
    vocab = MODEL["vocab_size"]
    shared = rng.integers(1, vocab, 128).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(64, 513))
        if i % 2 == 0 and n > 128:
            prompts.append(shared + rng.integers(1, vocab, n - 128).tolist())
        else:
            prompts.append(rng.integers(1, vocab, n).tolist())
    return prompts


def serving_phase(model, prompts, kv_quant, device) -> dict:
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops.paged_attention import KERNEL
    from distributed_pytorch_tpu_torch.serving import InferenceEngine, SamplingParams

    engine = InferenceEngine(
        model, max_slots=MAX_SLOTS, max_seq_len=MAX_SEQ_LEN, page_size=PAGE,
        token_budget=64, max_prefill_chunk=32, max_queue=N_REQUESTS,
        paged_kernel=True, kv_quant=kv_quant, device=device,
    )
    params = SamplingParams(max_new_tokens=NEW_TOKENS)
    # Warm-up (cuBLAS handles, the allocator): one short request, not counted.
    engine.submit(prompts[0][:16], SamplingParams(max_new_tokens=2))
    engine.run()
    engine.metrics = type(engine.metrics)()
    steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ids = [engine.submit(p, params) for p in prompts]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES[KERNEL]

    decode_steps = engine.decode_steps - steps0
    outs = [engine.poll(i) for i in ids]
    stats = engine.stats()
    engine.close()
    if not all(o.finished and len(o.generated) == NEW_TOKENS for o in outs):
        fail(f"serving ({kv_quant or 'fp'}): not every request finished")
    if not all(0 <= t < MODEL["vocab_size"] for o in outs for t in o.generated):
        fail(f"serving ({kv_quant or 'fp'}): token out of vocabulary")
    if launches != decode_steps * MODEL["n_layers"]:
        fail(
            f"serving ({kv_quant or 'fp'}): {launches} K4 launches, expected "
            f"{decode_steps} decode steps x {MODEL['n_layers']} layers"
        )
    tokens = sum(len(o.generated) for o in outs)
    result = {
        "kv": kv_quant or "fp",
        "requests": len(outs),
        "generated_tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": stats["ttft_s_p50"],
        "tpot_p50_s": stats["tpot_s_p50"],
        "prompt_tokens": sum(len(p) for p in prompts),
        "engine_steps": stats["engine_steps"],
        "decode_steps": decode_steps,
        "prefill_chunks": engine.prefill_chunks - chunks0,
        "k4_launches": launches,
        "prefix_tokens_hit": stats.get("prefix_tokens_hit"),
        "preemptions": stats["preemptions"],
    }
    print("serving " + json.dumps(result), flush=True)
    result["sequences"] = [p + o.generated for p, o in zip(prompts, outs)]
    return result


def teacher_forced_logits(model, seqs, prompt_lens, kv_quant, kernel, device):
    """Feed two finished sequences back through the model: prefill each
    prompt but its last token, then decode both rows together one position
    at a time. Returns the logits [steps, 2, V]."""
    cache = model.init_paged_cache(2 * PAGES_PER_SEQ + 1, PAGE, kv_quant, device=device)
    tables = torch.arange(1, 2 * PAGES_PER_SEQ + 1, dtype=torch.int32, device=device)
    tables = tables.view(2, PAGES_PER_SEQ)
    with torch.no_grad():
        for row, (seq, n) in enumerate(zip(seqs, prompt_lens)):
            model(
                torch.tensor([seq[: n - 1]], device=device), cache=cache,
                block_tables=tables[row : row + 1],
                seq_lens=torch.zeros(1, dtype=torch.int32, device=device), logits=None,
            )
        out = []
        for j in range(NEW_TOKENS):
            pos = [n - 1 + j for n in prompt_lens]
            cur = torch.tensor([[s[p]] for s, p in zip(seqs, pos)], device=device)
            out.append(
                model(
                    cur, cache=cache, block_tables=tables,
                    seq_lens=torch.tensor(pos, dtype=torch.int32, device=device),
                    paged_kernel=kernel, logits="last",
                )
            )
    return torch.stack(out)


def teacher_forced_check(model, prompts, served, kv_quant, device) -> float:
    pick = [0, 1]
    seqs = [served["sequences"][i] for i in pick]
    plens = [len(prompts[i]) for i in pick]
    with_kernel = teacher_forced_logits(model, seqs, plens, kv_quant, True, device)
    plain = teacher_forced_logits(model, seqs, plens, kv_quant, False, device)
    torch.cuda.synchronize()
    if not torch.isfinite(with_kernel).all() or not torch.isfinite(plain).all():
        fail("teacher-forced logits are not finite")
    err = (with_kernel - plain).abs().max().item()
    agree = (with_kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(
        f"teacher-forced ({kv_quant or 'fp'}, 2 requests x {NEW_TOKENS} "
        f"positions): max |logit kernel - plain| {err:.4f} (tol {LOGIT_TOL}), "
        f"argmax agreement {agree:.4f}, logit scale "
        f"{plain.abs().max().item():.3f}",
        flush=True,
    )
    if err > LOGIT_TOL:
        fail(f"teacher-forced logits differ by {err} > {LOGIT_TOL}")
    return err


def flash_problem(gen, bh, t, d, dtype, device):
    return tuple(
        torch.randn(bh, t, d, generator=gen, device=device).to(dtype) for _ in range(4)
    )


def flash_errors(q, k, v, do, causal, window, q_offset):
    """Check out, lse, dQ, dK and dV of one problem against the plain
    versions at the limits of q's dtype (lse: float32's). Returns, per
    tensor, (max |kernel - plain|, median |plain|, share of the limit used)."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_fwd(q, k, v, causal, window, q_offset)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, causal, window, q_offset)
    delta = (do.float() * ref_out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, ref_lse, delta, causal, window, q_offset)
    pairs = {
        "out": (out, ref_out),
        "lse": (lse, ref_lse),
        "dq": (fa.flash_bwd_dq(*args), fa.flash_bwd_dq_reference(*args)),
    }
    pairs["dk"], pairs["dv"] = zip(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    errs = {}
    for name, (got, ref) in pairs.items():
        tol = LSE_TOL if name == "lse" else FLASH_TOL[q.dtype]
        per_row = name != "lse" and q.dtype == torch.bfloat16
        if not torch.isfinite(got).all():
            fail(f"flash {name}: non-finite output")
        used = limit_used(got, ref, tol, per_row)
        if not used <= 1.0:
            fail(f"flash {name} (T={q.shape[1]}, D={q.shape[2]}, {q.dtype}, "
                 f"causal={causal}, window={window}, q_offset={q_offset}): "
                 f"beyond {tol} (abs, rel{', by row' if per_row else ''}), "
                 f"{used:.2f} of the limit")
        errs[name] = ((got.float() - ref.float()).abs().max().item(),
                      ref.float().abs().median().item(), used)
    return errs


def describe_errors(errs: dict) -> str:
    return " ".join(f"{k} {e:.2e} (median |ref| {m:.2e}, {u:.2f} of limit)"
                    for k, (e, m, u) in errs.items())


def plain_in_chunks(fn, *tensors, heads=4):
    """The plain version four (b, h) slabs at a time, concatenated: heads
    are independent, so this is the same function in less memory."""
    outs = [fn(*(x[i : i + heads] for x in tensors)) for i in range(0, tensors[0].shape[0], heads)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def flash_phase(device) -> dict:
    """K1-K3 against their plain versions over the cover, then timed at the
    training path's shapes. Returns the kernels-line fields per kernel."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    masks = [(False, 0, 0), (True, 0, 0), (True, 256, 0), (True, 256, 300)]
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            worst = {}
            for causal, window, q_offset in masks:
                for t in (1, 100, 1000, 1024):
                    bh = 32 if t <= 100 else 16
                    errs = flash_errors(*flash_problem(gen, bh, t, d, dtype, device),
                                        causal, window, q_offset)
                    for k, e in errs.items():  # keep the problem nearest its limit
                        if k not in worst or e[2] > worst[k][2]:
                            worst[k] = e
            atol, rtol = FLASH_TOL[dtype]
            by = "row RMS" if dtype == torch.bfloat16 else "element"
            print(f"flash kernels {str(dtype)[6:]} D={d} (4 masks x T in 1/100/1000/1024; "
                  f"tol {atol:.0e} abs + {rtol:.0e} rel by {by}, lse {LSE_TOL[0]:.0e} + "
                  f"{LSE_TOL[1]:.0e} by element): " + describe_errors(worst), flush=True)

    # with_lse: the lse cotangent folds into delta; hold the kernels'
    # gradient against autograd through the plain forward (fp32).
    q, k, v, g = (x.requires_grad_() if i < 3 else x
                  for i, x in enumerate(flash_problem(gen, 8, 1000, 128, torch.float32, device)))
    dlse = torch.randn(*q.shape[:2], 1, generator=gen, device=device)
    grads = []
    for fwd in (lambda: fa.flash_attention_with_lse(q, k, v, True, 256, 0),
                lambda: fa.flash_fwd_reference(q, k, v, True, 256, 0)):
        out, lse = fwd()
        grads.append(torch.autograd.grad((out * g).sum() + (lse * dlse).sum(), (q, k, v)))
    torch.cuda.synchronize()
    lse_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"flash with_lse backward (fp32, T=1000, window 256, dlse != 0) vs "
          f"autograd through the plain forward: {lse_err:.2e} (tol {WITH_LSE_TOL:.0e})",
          flush=True)
    if not all(agrees(a, b, (WITH_LSE_TOL, WITH_LSE_TOL)) for a, b in zip(*grads)):
        fail(f"flash with_lse backward differs by {lse_err}")

    # Timing at the training path's shapes.
    b, h, t, d = TRAIN_BATCH, MODEL["n_heads"], TRAIN_T, MODEL["d_model"] // MODEL["n_heads"]
    q, k, v, do = flash_problem(gen, b * h, t, d, torch.bfloat16, device)
    out, lse = fa.flash_fwd(q, k, v, True)
    ref_out, ref_lse = plain_in_chunks(
        lambda *x: fa.flash_fwd_reference(*x, True), q, k, v)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    bwd_args = (q, k, v, do, lse, delta)
    dq = fa.flash_bwd_dq(*bwd_args, True)
    dk, dv = fa.flash_bwd_dkv(*bwd_args, True)
    ref_dq = plain_in_chunks(lambda *x: fa.flash_bwd_dq_reference(*x, True), *bwd_args)
    ref_dk, ref_dv = plain_in_chunks(lambda *x: fa.flash_bwd_dkv_reference(*x, True), *bwd_args)
    torch.cuda.synchronize()
    main_err, shown = {}, {}
    for name, part, got, ref in (
        ("fwd", "out", out, ref_out), ("fwd", "lse", lse, ref_lse), ("dq", "dq", dq, ref_dq),
        ("dkv", "dk", dk, ref_dk), ("dkv", "dv", dv, ref_dv),
    ):
        tol = LSE_TOL if part == "lse" else FLASH_TOL[torch.bfloat16]
        used = limit_used(got, ref, tol, per_row=part != "lse")
        if not used <= 1.0:
            fail(f"flash {part} at the training shapes: beyond {tol} (abs, rel), "
                 f"{used:.2f} of the limit")
        err = (got.float() - ref.float()).abs().max().item()
        shown[part] = (err, ref.float().abs().median().item(), used)
        if part != "lse":  # the kernels line's max_abs_err: the bf16 outputs
            main_err[name] = max(main_err.get(name, 0.0), err)
    print("flash kernels at the training shapes (B=2, H=16, T=8192, D=128, causal, "
          "bf16): " + describe_errors(shown), flush=True)
    del ref_out, ref_lse, ref_dq, ref_dk, ref_dv

    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)  # 256 MB
    ms = {
        "fwd": time_ms(lambda: fa.flash_fwd(q, k, v, True), 5, flush),
        "dq": time_ms(lambda: fa.flash_bwd_dq(*bwd_args, True), 5, flush),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv(*bwd_args, True), 5, flush),
    }
    plain_ms = {
        "fwd": time_ms(lambda: plain_in_chunks(
            lambda *x: fa.flash_fwd_reference(*x, True), q, k, v), 2, flush),
        "dq": time_ms(lambda: plain_in_chunks(
            lambda *x: fa.flash_bwd_dq_reference(*x, True), *bwd_args), 2, flush),
        "dkv": time_ms(lambda: plain_in_chunks(
            lambda *x: fa.flash_bwd_dkv_reference(*x, True), *bwd_args), 2, flush),
    }
    q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_() for x in (q, k, v))
    g4 = do.view(b, h, t, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 10, flush)
    sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(q4, k4, v4, is_causal=True), (q4, k4, v4), g4), 10, flush)
    # SDPA's backward computes dQ, dK and dV in one call: no library call
    # does K2's or K3's work alone, so their library_ms is null and the
    # combined backward is printed once beside K2 + K3.
    sdpa_bwd = sdpa_fwd_bwd - sdpa_fwd
    library_ms = {"fwd": sdpa_fwd, "dq": None, "dkv": None}

    # Bounds: the visible (query, key) pairs of causal attention, 2 flops per
    # multiply-add per head dim per product (K1: S and PV; K2: S, dP, dQ; K3:
    # S, dP, dV, dK) over the bf16 peak; bytes: each bf16 operand read once,
    # each output written once, lse and delta 4 bytes a row.
    pairs = b * h * t * (t + 1) // 2
    slab = b * h * t * d * 2
    rows = b * h * t * 4
    work = {
        "fwd": (2, 3 * slab + slab + rows),
        "dq": (3, 4 * slab + 2 * rows + slab),
        "dkv": (4, 4 * slab + 2 * rows + 2 * slab),
    }
    result = {}
    for name, (products, nbytes) in work.items():
        flops = products * 2 * pairs * d
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        result[name] = {
            "max_abs_err": main_err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms[name],
        }
        sdpa_text = "n/a" if library_ms[name] is None else f"{library_ms[name]:.3f} ms"
        print(f"flash {name} timing (B={b}, H={h}, T={t}, D={d}, causal, bf16): "
              f"kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.3f} ms, sdpa "
              f"{sdpa_text}, bound {result[name]['bound_ms']:.4f} ms "
              f"({flops} flop / 989 TFLOP/s; {nbytes} B / 3.35 TB/s = "
              f"{bytes_ms:.4f} ms), max_abs_err {main_err[name]:.3e}", flush=True)
    print(f"flash backward timing: K2 + K3 {ms['dq'] + ms['dkv']:.3f} ms, sdpa backward "
          f"(dQ, dK, dV in one call; forward+backward minus forward) {sdpa_bwd:.3f} ms, "
          f"bound {result['dq']['bound_ms'] + result['dkv']['bound_ms']:.4f} ms", flush=True)
    return result


def train_model(device, seed=SEED):
    from distributed_pytorch_tpu_torch.models.transformer import TransformerLM, init_random_

    model = TransformerLM(**MODEL, dtype=torch.bfloat16, param_dtype=torch.float32,
                          device=device)
    return init_random_(model, seed)


class EpochLog:
    """A MetricLogger that also keeps the epoch losses it prints."""

    def __init__(self):
        from distributed_pytorch_tpu_torch.metrics import MetricLogger

        self.inner = MetricLogger()
        self.epoch_losses = []

    def log(self, step, **scalars):
        if "epoch_loss" in scalars:
            self.epoch_losses.append(scalars["epoch_loss"])
        self.inner.log(step, **scalars)

    def close(self):
        self.inner.close()


def training_phase(device) -> dict:
    """The port's Trainer on the full-width model: epoch 0, then a fresh
    Trainer resuming from the snapshot for epoch 1."""
    from distributed_pytorch_tpu_torch.obs.goodput import transformer_train_flops
    from distributed_pytorch_tpu_torch.ops import _build
    from distributed_pytorch_tpu_torch.ops.flash_attention import (
        KERNEL_BWD_DKV, KERNEL_BWD_DQ, KERNEL_FWD,
    )
    from distributed_pytorch_tpu_torch.training import Trainer, softmax_cross_entropy_loss
    from distributed_pytorch_tpu_torch.utils.data import ArrayDataset, ShardedLoader

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, MODEL["vocab_size"], (TRAIN_SEQS, TRAIN_T + 1))
    loader = ShardedLoader(ArrayDataset(tokens[:, :-1], tokens[:, 1:]), TRAIN_BATCH,
                           shuffle=True, seed=SEED)
    step_s = []

    def build(tmp, seed):
        model = train_model(device, seed)
        trainer = Trainer(
            model, loader, torch.optim.Adam(model.parameters(), lr=TRAIN_LR), 1,
            snapshot_path=os.path.join(tmp, "snapshot.npz"),
            loss_fn=softmax_cross_entropy_loss, metrics=EpochLog(), device=device,
        )
        step = trainer.train_step

        def timed(state, batch):  # device time of each step, for the report
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        trainer.train_step = timed
        return trainer

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        first = build(tmp, SEED)
        first.train(1)
        losses = list(first.metrics.epoch_losses)
        steps_epoch0 = first.state.step
        del first
        torch.cuda.empty_cache()
        # A fresh Trainer on another init: the snapshot must override it.
        second = build(tmp, SEED + 7)
        if second.epochs_run != 1 or second.state.step != steps_epoch0:
            fail(f"resume: epochs_run {second.epochs_run}, step {second.state.step}; "
                 f"expected 1 and {steps_epoch0}")
        second.train(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses += second.metrics.epoch_losses
        snapshot_bytes = os.path.getsize(os.path.join(tmp, "snapshot.npz"))
        disk_free_gb = shutil.disk_usage(tmp).free / 1e9
        final_step = second.state.step
        del second
    launches = {name: _build.LAUNCHES[name] for name in (KERNEL_FWD, KERNEL_BWD_DQ, KERNEL_BWD_DKV)}
    steps = len(loader) * 2
    if final_step != steps or len(step_s) != steps:
        fail(f"training ran {final_step} steps ({len(step_s)} timed), expected {steps}")
    expected = MODEL["n_layers"] * steps
    if any(n != expected for n in launches.values()):
        fail(f"training launched {launches}, expected {expected} each "
             f"({MODEL['n_layers']} layers x {steps} steps)")
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"epoch losses {losses}")
    if abs(losses[0] - LOSS_START) > LOSS_BAND:
        fail(f"epoch-0 loss {losses[0]} not within {LOSS_BAND} of {LOSS_START:.3f}")
    p50 = sorted(step_s)[len(step_s) // 2]
    d = MODEL["d_model"]
    from distributed_pytorch_tpu_torch.models.transformer import TransformerLM

    n_params = sum(p.numel() for p in TransformerLM(**MODEL, device="meta").parameters())
    flops = transformer_train_flops(
        n_params=n_params, embed_params=MODEL["vocab_size"] * d,
        n_layers=MODEL["n_layers"], n_heads=MODEL["n_heads"], head_dim=d // MODEL["n_heads"],
        seq_len=TRAIN_T, batch=TRAIN_BATCH,
    )
    result = {
        "steps": steps,
        "epoch_losses": losses,
        "loss_minus_ln_vocab": losses[0] - math.log(MODEL["vocab_size"]),
        "step_s_p50": p50,
        "step_s": step_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_T / p50,
        "train_flops_per_step": flops,
        "mfu": flops / p50 / BF16_FLOPS_PER_S,
        "wall_s": wall,
        "snapshot_bytes": snapshot_bytes,
        "disk_free_gb_after": disk_free_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    print("training " + json.dumps(result), flush=True)
    return result


@contextlib.contextmanager
def plain_attention(fault=None):
    """Route the model's attention through the plain dense version, or,
    with ``fault`` (one of FAULTS), through a planted fault of it."""
    from distributed_pytorch_tpu_torch.models import transformer
    from distributed_pytorch_tpu_torch.ops.attention import dot_product_attention

    def attend(q, k, v, *, causal, window):
        if fault == "no_causal_mask":
            return dot_product_attention(q, k, v)
        if fault == "dk_zero":
            k = k.detach()
        elif fault == "dk_5pct":
            k.register_hook(lambda g: g * 0.95)
        return dot_product_attention(q, k, v, causal=causal, window=window)

    saved = transformer.flash_attention
    transformer.flash_attention = attend
    try:
        yield
    finally:
        transformer.flash_attention = saved


def training_step_check(device) -> dict:
    """One training step at T=1024 through the kernels and through the
    plain attention, from the same weights and batch; then through each
    planted fault, which must fail the same limits."""
    from distributed_pytorch_tpu_torch.training import (
        create_train_state, make_train_step, softmax_cross_entropy_loss,
    )

    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(rng.integers(0, MODEL["vocab_size"], (TRAIN_BATCH, CHECK_T + 1)))
    batch = (tokens[:, :-1].to(device), tokens[:, 1:].to(device))
    runs = [("kernels", contextlib.nullcontext()), ("plain", plain_attention())]
    runs += [(fault, plain_attention(fault)) for fault in FAULTS]
    out = {}
    for name, ctx in runs:
        model = train_model(device)
        opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)
        step = make_train_step(model, opt, softmax_cross_entropy_loss)
        with ctx:
            _, loss = step(create_train_state(model, opt), batch)
        norms = {n: 0.0 if p.grad is None else p.grad.float().norm().item()
                 for n, p in model.named_parameters()}
        out[name] = (loss.item(), norms)
        del model, opt
    torch.cuda.synchronize()

    def gaps(name):
        (loss, norms), (loss_p, norms_p) = out[name], out["plain"]
        rel = max(abs(norms[n] - norms_p[n]) / max(norms_p[n], 1e-12) for n in norms_p)
        return loss, abs(loss - loss_p), rel

    loss_k, loss_gap, rel = gaps("kernels")
    print(f"training step at T={CHECK_T}, kernels vs plain attention: loss "
          f"{loss_k:.6f} vs {out['plain'][0]:.6f}, gap {loss_gap:.3e} (tol {STEP_LOSS_TOL}), "
          f"max relative gradient-norm difference {rel:.3e} over {len(out['plain'][1])} "
          f"tensors (tol {STEP_GRAD_RTOL})", flush=True)
    if not math.isfinite(loss_k) or loss_gap > STEP_LOSS_TOL:
        fail(f"training step loss {loss_k} vs plain {out['plain'][0]}")
    if not rel <= STEP_GRAD_RTOL:
        fail(f"training step gradient norms differ by {rel} (relative)")
    controls = {}
    for fault in FAULTS:
        _, f_loss_gap, f_rel = gaps(fault)
        caught = f_loss_gap > STEP_LOSS_TOL or f_rel > STEP_GRAD_RTOL
        print(f"training step control {fault}: loss gap {f_loss_gap:.3e}, max relative "
              f"gradient-norm difference {f_rel:.3e}: "
              + ("fails the limits, as it must" if caught else "PASSES the limits"), flush=True)
        if not caught:
            fail(f"planted fault {fault} passes the training-step limits")
        controls[fault] = {"loss_gap": f_loss_gap, "grad_norm_rel": f_rel}
    return {"loss_kernels": loss_k, "loss_gap": loss_gap, "grad_norm_rel": rel,
            "controls": controls}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from distributed_pytorch_tpu_torch.models.transformer import (
        TransformerLM,
        init_random_,
    )
    from distributed_pytorch_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}",
        flush=True,
    )
    t0 = time.perf_counter()
    built = _build.build_all()
    print(
        f"build: {time.perf_counter() - t0:.2f} s "
        + json.dumps({k: round(v, 2) for k, v in built.items()}),
        flush=True,
    )

    k4 = kernel_phase(device)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(**MODEL, dtype=torch.bfloat16, device=device)
    init_random_(model, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} params, bf16 compute, seed {SEED}", flush=True)
    prompts = make_requests()
    launches = 0
    for kv_quant in (None, "int8"):
        served = serving_phase(model, prompts, kv_quant, device)
        launches += served["k4_launches"]
        teacher_forced_check(model, prompts, served, kv_quant, device)

    flash = flash_phase(device)
    del model
    torch.cuda.empty_cache()
    training = training_phase(device)
    training_step_check(device)

    kernels = [{
        "name": "paged_attention_decode",
        "route": "cuda",
        "source": "distributed_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "distributed_pytorch_tpu/ops/paged_attention.py:158",
        "launches": launches,
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]
    for name, replaces in (
        ("flash_fwd", "distributed_pytorch_tpu/ops/flash_attention.py:77"),
        ("flash_bwd_dq", "distributed_pytorch_tpu/ops/flash_attention.py:146"),
        ("flash_bwd_dkv", "distributed_pytorch_tpu/ops/flash_attention.py:195"),
    ):
        row = flash[name.replace("flash_", "").replace("bwd_", "")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "distributed_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": training["launches"][name],
            **row,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
