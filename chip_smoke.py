#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (kernels are built from
``horovod_tpu_torch/csrc`` into ``build/`` at first use).  Phases, one JSON
line each:

1. device      — ``nvidia-smi`` name and power limit (also printed raw on a
                 line of its own), torch and CUDA versions;
2. build       — every kernel compiled, one ``nvcc`` per source in
                 parallel;
3. flash       — the flash-attention forward kernel against its plain
                 PyTorch version at ``[1, S, 6, 128]`` and the training
                 shape ``[8, 1024, 6, 128]``, bf16, with times of the
                 kernel, the plain version and
                 ``F.scaled_dot_product_attention`` (a yardstick only), the
                 card's bound for the same work and its share of the
                 kernel's time; and at ``[1, 1024, 6, D]`` for D = 96
                 (zero-padded to 128) and 256 (the CUDA-core route), with
                 q, k, v (and dO) as strided views, at ``[1, 1024, 2, D]``
                 for D = 320 and 512 (the wide route) and at
                 ``[16385, 64, 4, 64]`` (B·H = 65540), those in bf16 and
                 f32;
4. flash_bwd   — the dq and dk/dv kernels against their plain versions on
                 the same ``(q, k, v, dO, lse, Δ)``, same fields (the
                 yardstick is the backward of the library call), each
                 with its own bound (dq: three products, one output;
                 dk/dv: four products, two outputs);
5. rmsnorm     — the RMSNorm forward kernel against its plain version at
                 ``[N, 768]`` bf16 for every N a main path gives it (the
                 run records each shape it launches at from ``serve`` to
                 ``train_accumulate`` and fails, in the ``rmsnorm_rows``
                 line, on one not checked here) and the f32 training
                 step's rows, same
                 fields, a profiled call at every row that must show
                 exactly one kernel, of the form the shape picks, and the
                 time of an empty launch beside it (the floor of the
                 decode rows); rows of 1 MiB or more are also timed from
                 HBM (inputs rotated through twice L2), beside a copy of
                 x from HBM (the same bytes moved), and their share of the
                 byte bound is taken from that time;
6. rmsnorm_bwd — the RMSNorm backward kernel likewise, and a profiled
                 call that must show exactly one kernel on the card (the
                 cross-block dscale sum included);
7. serve       — the 162M decoder on the card with seeded weights, 16
                 requests through ``ServingEngine.submit`` /
                 ``run_until_idle``; launch counts of the forward kernels
                 over that run; one prefill repeated through the plain
                 versions;
   serve_paged — the same model on ``PagedTransformerBackend`` (8 slots,
                 2048 positions, 16-token pages, 512 cache pages): 16
                 requests of ``loadgen.make_arrivals`` (3/4 open with a
                 512-token shared prefix, then 100-400 tokens; 32 new
                 each), all submitted at once after a warm-up request,
                 through (a) the cache, (b) the cache off (a fresh pool
                 with no cache pages, every prefix lookup missing), (c)
                 the cache with speculation (``spec_k`` 4) and (d) the
                 dense ``TransformerBackend``.  Checks: every request ends
                 with 32 tokens; (a) hits, in whole pages; the shared
                 prefix's pages bitwise unchanged from their first write
                 to the end of (a); 0 flash and >= 25 RMSNorm launches a
                 prefill, decode or verify call in (a)-(c), 12 flash a
                 prefill in (d); (a)'s, (c)'s and (d)'s token streams
                 equal (b)'s, leaving them only at a near tie (see
                 :func:`compare_streams`); and a verify block of (b)'s own
                 tokens on (b)'s pool, every draft accepted, then a decode
                 step that reads the block back (see
                 :func:`check_verify_block`).  Prints TTFT, token gaps,
                 tokens/s, hit and acceptance rates, pool bytes, peak
                 memory and the decode step's page gather and scatter
                 device ms;
   router      — a ``Router`` over two 162M models on the card, ``chat``
                 paged (seed 0) and ``code`` dense (seed 1), one 8-slot
                 replica each, 8 requests of 100-400 tokens with 16 new
                 each per model.  Checks: every request completes on its
                 own model, the launches (code's prefills: 12 flash each),
                 and chat's streams against the same requests each run
                 alone on a paged engine.  Prints per-model ``stats()``
                 (SLO attainment at a 1000 ms TTFT target) and one
                 ``RouterAutoscaler.decide`` verdict;
8. train       — the 162M training step of
                 ``python -m horovod_tpu_torch.train_transformer``
                 (``init`` on NCCL, ``DistributedOptimizer(AdamW)``, B=8,
                 S=1024): 3 warm-up and 10 timed steps, a falling finite
                 loss, exact launches of all five kernels per step, one
                 step's gradients through the kernels against the same step
                 through the plain versions, step time, tokens/s, MFU, peak
                 memory, device time by kind of kernel and kernels per
                 step, and the overlap plan (the width-1 bypass);
   train_mixed — the same step with ``--bf16-params``:
                 ``DistributedOptimizer(master_weights(AdamW))`` over
                 bf16-resident parameters, the same checks and numbers,
                 and every resident parameter against bf16(its master);
   train_remat — the step with ``--remat``: one step's gradients against
                 the plain step's (bit-equal, or within the train bounds),
                 launches 24/12/12/49/25 a step, peak memory below
                 ``train``'s;
   train_accumulate — ``--accumulate 4`` at B = 8: loss and gradients
                 against the full-batch step within the train bounds, and
                 four times a step's launches;
9. resnet      — the ResNet-50 step of ``python -m
                 horovod_tpu_torch.train_resnet`` at full size (128 images
                 of 224×224×3 on the card, bf16 over f32 parameters,
                 ``DistributedOptimizer(SGD(0.01, momentum=0.9))``): 3
                 warm-up and 8 timed steps, img/s, step time, device busy
                 time and idle share, device time by kind, peak memory, a
                 finite loss falling on the fixed batch, and
                 ``overlap_plan()``, which must be the adaptive planner's
                 width-1 bypass;
10. kernels    — ``{"kernels": [...]}``, one entry per kernel of the path,
                 with the form it runs in for bf16 inputs (the three flash
                 kernels on the tensor cores, the two RMSNorm kernels on
                 the CUDA cores) and a line on its design; ``launches`` is
                 the sum over the serve, serve_paged (a-d), router and
                 train runs, each counted from 0 around its own run
                 (``launches_by_run``).

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without that line; it exits non-zero
too when no CUDA device is present or the package is not beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20
# Below this many bytes a call (the decode rows) is bound by its launch,
# not by HBM: it is read against an empty launch's time, and has no share
# of the byte bound.
RMS_HBM_MIN_BYTES = 2**20

SEED = 0
# serve_paged: 16 requests, 3/4 of them opening with a 512-token shared
# prefix, each then a 100-400-token tail and 32 new tokens, on 16-token
# pages with 512 cache pages; speculation drafts 4 tokens.  router: two
# models of 8 requests of 100-400 tokens, 16 new each, a 1 s TTFT target.
PAGED_SHARED_LEN, PAGED_REQUESTS, PAGED_NEW = 512, 16, 32
PAGE_SIZE, PAGED_CACHE_PAGES, PAGED_SPEC_K = 16, 512, 4
ROUTER_REQUESTS, ROUTER_NEW, ROUTER_SLO_MS = 8, 16, 1000.0
# (B, S_q, S_k, causal, q_offset): [B, S, 6, 128] bf16.  The serving
# prefill buckets, S=1000 (masked edge tiles), a longer and a non-causal
# row, a query block past its keys, the training step's shape, and one
# microbatch of it under `--accumulate 4` (B = 2).
FLASH_SHAPES = (
    (1, 128, 128, True, 0), (1, 256, 256, True, 0), (1, 512, 512, True, 0),
    (1, 1000, 1000, True, 0), (1, 1024, 1024, True, 0),
    (1, 2048, 2048, True, 0), (1, 1024, 1024, False, 0),
    (1, 128, 1024, True, 896), (8, 1024, 1024, True, 0),
    (2, 1024, 1024, True, 0))
FLASH_BWD_SHAPES = (
    (8, 1024, 1024, True, 0), (2, 1024, 1024, True, 0),
    (1, 128, 128, True, 0),
    (1, 1000, 1000, True, 0), (1, 2048, 2048, True, 0),
    (1, 1024, 1024, False, 0), (1, 128, 1024, True, 896))
FLASH_MAIN = (8, 1024, 1024, True, 0)   # one training step's attention
# Rows past the training shapes, each (B, S_q, S_k, causal, q_offset, D,
# strided, H, dtype): head dims the wrappers pad (96 -> 128) or route to the
# CUDA cores (256), q, k, v, dO as transposed views of [B, H, S, D]; head
# dims past 256 (the wide route, each block a 64-column slice of the
# output), in bf16 and f32; and B*H = 65540, past the 65535 a grid's y
# axis takes, in bf16 (tensor cores) and f32 (CUDA cores).
FLASH_MORE = ((1, 1024, 1024, True, 0, 96, False, 6, torch.bfloat16),
              (1, 1024, 1024, True, 0, 256, False, 6, torch.bfloat16),
              (1, 1024, 1024, True, 0, 128, True, 6, torch.bfloat16)) + tuple(
    (1, 1024, 1024, True, 0, d, False, 2, dt) for d in (320, 512)
    for dt in (torch.bfloat16, torch.float32)) + tuple(
    (16385, 64, 64, True, 0, 64, False, 4, dt)
    for dt in (torch.bfloat16, torch.float32))
# [N, 768] bf16: every row count the main paths give the forward kernel
# (8 decode slots; the paged verify block of 8 slots x 5; the prefill
# buckets 128-1024; a microbatch of 2 x 1024; a training step's 8192),
# and 1 and 1000.  ``main`` fails when a main path gives it another
# (``record_norm_rows``).
RMS_ROWS = (1, 8, 40, 128, 256, 512, 1000, 1024, 2048, 8192)
# (dtype, N) of the RMSNorm forward's checks: the bf16 rows of every path
# (register form) and the f32 training step's rows (3 KB: the loop form).
RMS_CASES = tuple((torch.bfloat16, n) for n in RMS_ROWS) + (
    (torch.float32, 8192),)
# (N, E) of the RMSNorm backward's checks: the 162M step's width, and
# widths past 7168 (the wide form, a block a row).
RMS_BWD_CASES = ((1000, 768), (2048, 768), (8192, 768), (1024, 8192),
                 (1024, 12288))
RMS_MAIN = 8192                         # one training step's tokens
RESNET_WARMUP, RESNET_STEPS = 3, 8
# bf16 outputs: |kernel - plain| <= ATOL + RTOL * |plain|.  Both compute in
# f32 and round once to bf16 (ulp 2**-8 relative), so they differ by at
# most about one ulp; ATOL covers f32 summation order near zero.  The
# forward kernel's P.V runs on the tensor cores with p entered as two bf16
# terms (bf16(p) + bf16(p - bf16(p)), ~16 significant bits), so p adds
# only f32-level error; one bf16 term would err by up to 2**-9 of each p,
# which on rows that see only a few keys exceeds FLASH_ATOL.
BF16_RTOL = 1.6e-2
FLASH_ATOL, RMS_ATOL, LSE_ATOL = 1e-3, 1e-5, 1e-4
# f32 flash rows (CUDA cores): kernel and plain version both keep every
# product in f32 and differ only in summation order; the card tests' bounds
# (forward, and each gradient, absolute and relative).
F32_FLASH_ATOL, F32_GRAD_TOL = 1e-5, 1e-4
# f32 RMSNorm: kernel and plain version sum x^2 in other orders, within a
# few f32 ulps of each other.
RMS_F32_RTOL = 1e-5
# Backward gradients in bf16: |kernel - plain| <= GRAD_ATOL * max|plain| +
# BF16_RTOL * |plain|.  Besides the final rounding to bf16, ds is rounded
# to bf16 before its products (the TPU kernel's contract), and where the
# two f32 values of ds straddle a rounding boundary the two round apart by
# one ulp; dq and dk sum up to S = 2048 such terms, so the bound scales
# with the gradient's magnitude.  The dk/dv kernel also rounds p to bf16
# as the tensor-core operand of dv = p^T.dO (the plain version keeps f32
# p): up to 2**-9 of each term, independent across the sum, far inside
# the bound.
GRAD_ATOL = 2e-2
# dscale sums N f32 terms in another order than the plain version: an
# error that grows like sqrt(N) times an f32 ulp of the partial sums.
DSCALE_ATOL_PER_SQRT_ROW = 1e-4
# The 162M step through the kernels against the same step through the
# plain versions, same weights and batch.  Both round every activation to
# bf16 at the same places, but where one value rounds the other way (one
# ulp, 2**-8 relative) it feeds every output of the next matrix product,
# so within a few layers the two routes' roundings decorrelate and their
# difference reaches the bf16 noise of the gradient itself (~2% measured
# on the H100).  Loss ~10.9: |dloss| <= 0.02.  Each parameter's gradient:
# ||g_kernel - g_plain|| / ||g_plain|| <= 0.05.
TRAIN_LOSS_ATOL = 0.02
TRAIN_GRAD_REL_L2 = 0.05
# The same step in f32 compute, where the roundings the routes take apart
# are 2**16 times finer: the same decorrelation leaves ~1e-6 (measured
# 3.6e-6), and a kernel computing another function fails by far more.
TRAIN_F32_LOSS_ATOL = 1e-4
TRAIN_F32_GRAD_REL_L2 = 1e-3
# Max |logits(kernels) - logits(plain)| over one 162M prefill.  Logits are
# about N(0, 1) with these weights; the two paths round the same f32 values
# to bf16 after every attention and norm, and a rounding that differs by
# one ulp (2**-8 relative) grows through 12 layers to a few hundredths.
LOGITS_ATOL = 0.125
# The paged K/V that a verify block writes against what decode steps write
# at the same positions, ||dK|| / ||K|| over each position's heads, each
# layer: the two round the same f32 values to bf16 after products of
# another M, and those roundings grow through the layers as the logits'
# do (a few percent).  A position written to the wrong page, or not at
# all, is >= 1 (an unwritten one, zeros, exactly 1).
KV_REL_L2 = 0.1
# ~50 ms of spinning at the H100's clock: longer than the host takes to
# enqueue the 20 calls of the slowest timed function.
SPIN_CYCLES = 100_000_000


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events).  A spin kernel queued first holds the stream while the host
    enqueues every call, so the host's own time per call (Python, the
    wrapper's checks, the launch) stays out of the reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, inputs) -> float:
    """:func:`time_ms` of ``fn`` on each of ``inputs`` in turn, its output
    kept until that input comes round again, so each call reads an input
    and writes an output that no call of the last ``len(inputs)`` touched.
    With those together larger than L2, each call's bytes come from and go
    to HBM."""
    turn = itertools.cycle(inputs)
    outs = collections.deque(maxlen=len(inputs))
    return time_ms(lambda: outs.append(fn(next(turn))))


def _peak_flops(dtype) -> float:
    """The card's peak for the operations' type: bf16 on the tensor cores,
    f32 on the CUDA cores."""
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else \
        PEAK_F32_CUDA_CORE_FLOPS


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_close(name, got, want, atol, rtol) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |diff| {err.max().item()}")
    return err.max().item()


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return {"card": card}


def phase_build():
    import horovod_tpu_torch.ops  # noqa: F401  (registers every kernel)
    from horovod_tpu_torch.ops import _build

    if sorted(_build.KERNELS) != ["flash_bwd_dkv", "flash_bwd_dq",
                                  "flash_fwd", "rmsnorm_bwd",
                                  "rmsnorm_fwd"]:
        raise AssertionError(f"kernels registered: {sorted(_build.KERNELS)}")
    def load(k):
        t = time.monotonic()
        k.load()
        return time.monotonic() - t

    # One thread per kernel, so every nvcc runs at once.
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        per = dict(zip(_build.KERNELS,
                       pool.map(load, _build.KERNELS.values())))
    ptxas = {name: [ln.strip() for ln in k.build_log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
             for name, k in _build.KERNELS.items()}
    emit("build", seconds=time.monotonic() - t0, per_kernel_s=per,
         ptxas=ptxas)


def _visible(s_q, s_k, causal, q_off):
    qpos = q_off + torch.arange(s_q, device="cuda")
    kpos = torch.arange(s_k, device="cuda")
    return (qpos[:, None] >= kpos[None, :]) if causal else \
        torch.ones(s_q, s_k, dtype=torch.bool, device="cuda")


def _sdpa(causal, q_off, visible):
    """``F.scaled_dot_product_attention`` over ``[B, H, S, D]`` with the
    flash kernel's mask: the library's yardstick."""
    import torch.nn.functional as F

    mask = visible if (causal and q_off) else None
    return lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=bool(causal and not q_off))


def _bshd(gen, b, s, h, d, strided, dtype=torch.bfloat16):
    """A ``[b, s, h, d]`` tensor on the card; ``strided``: a transposed
    view of a ``[b, h, s, d]`` one."""
    if strided:
        return torch.randn(b, h, s, d, generator=gen, device="cuda",
                           dtype=dtype).transpose(1, 2)
    return torch.randn(b, s, h, d, generator=gen, device="cuda",
                       dtype=dtype)


def _is_main(row) -> bool:
    return tuple(row[:5]) == FLASH_MAIN and tuple(row[5:7]) == (128, False)


def _flash_rows(shapes):
    """The training and serving rows (``[B, S, 6, 128]`` bf16), then
    :data:`FLASH_MORE`."""
    return tuple(r + (128, False, 6, torch.bfloat16)
                 for r in shapes) + FLASH_MORE


def _flash_route(d: int, dtype=torch.bfloat16) -> str:
    """The route of a call at head dim ``d`` (see
    ``ops/flash_attention.py``)."""
    from horovod_tpu_torch.ops import flash_attention as fa

    dk = fa.kernel_head_dim(d)
    route = "tensor cores" if dk in (64, 128) and dtype == torch.bfloat16 \
        else "CUDA cores" + (", a 64-column slice a block" if dk > 256
                             else "")
    return route + (f", zero-padded to D={dk}" if dk != d else "")


def _flash_tolerances(dtype):
    """The forward's (atol, rtol) and a gradient's (atol as a function of
    the plain gradient, rtol): f32 kernels and plain versions differ in
    summation order only; bf16 bounds scale with the gradient (see
    GRAD_ATOL)."""
    if dtype == torch.float32:
        return ((F32_FLASH_ATOL, F32_FLASH_ATOL),
                (lambda want: F32_GRAD_TOL, F32_GRAD_TOL))
    return ((FLASH_ATOL, BF16_RTOL),
            (lambda want: GRAD_ATOL * want.abs().max().item(), BF16_RTOL))


def phase_flash() -> dict:
    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, main = 0.0, None
    for row_key in _flash_rows(FLASH_SHAPES):
        b, s_q, s_k, causal, q_off, d, strided, h, dtype = row_key
        q = _bshd(gen, b, s_q, h, d, strided, dtype)
        k, v = (_bshd(gen, b, s_k, h, d, strided, dtype) for _ in range(2))
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, q_off, 0)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                        q_off, 0)
        torch.cuda.synchronize()
        tag = f"flash B={b} S_q={s_q} S_k={s_k} H={h} causal={causal} " \
              f"q_offset={q_off} D={d} strided={strided} {dtype}"
        (atol, rtol), _ = _flash_tolerances(dtype)
        err = check_close(tag + " out", out, ref_out, atol, rtol)
        lse_err = check_close(tag + " lse", lse, ref_lse, LSE_ATOL, 0.0)
        del ref_out, ref_lse
        if dtype == torch.bfloat16:
            worst = max(worst, err, lse_err)
        visible = _visible(s_q, s_k, causal, q_off)
        pairs = b * int(visible.sum())
        size = q.element_size()
        flops = 4.0 * h * d * pairs
        nbytes = size * b * (2 * s_q + 2 * s_k) * h * d + 4.0 * b * s_q * h
        bound_ms, bound_by = bound(flops, nbytes, _peak_flops(dtype))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = _sdpa(causal, q_off, visible)
        row = dict(
            shape=[b, s_q, h, d], s_k=s_k, causal=causal, q_offset=q_off,
            strided=strided, dtype=str(dtype).removeprefix("torch."),
            route=_flash_route(d, dtype), max_abs_err=err,
            lse_max_abs_err=lse_err,
            kernel_ms=time_ms(lambda: fa.flash_attention_with_lse(
                q, k, v, causal, q_off, 0)),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal, q_off, 0)),
            library_ms=time_ms(lambda: lib(qt, kt, vt)),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
        row["share_of_bound"] = bound_ms / row["kernel_ms"]
        emit("flash", **row)
        if _is_main(row_key):
            main = row
        del q, k, v, qt, kt, vt, out, lse
    main["max_abs_err"] = worst
    return main


def phase_flash_bwd() -> tuple[dict, dict]:
    """The dq and dk/dv kernels against their plain versions, on the same
    inputs, with lse from the forward kernel."""
    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"dq": 0.0, "dkv": 0.0}
    main = {}
    for row_key in _flash_rows(FLASH_BWD_SHAPES):
        b, s_q, s_k, causal, q_off, d, strided, h, dtype = row_key
        q, dout = (_bshd(gen, b, s_q, h, d, strided, dtype)
                   for _ in range(2))
        k, v = (_bshd(gen, b, s_k, h, d, strided, dtype) for _ in range(2))
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, q_off, 0)
        delta = (dout.float() * out.float()).sum(dim=-1)
        args = (q, k, v, dout, lse, delta, causal, q_off, 0)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        want_dq = fa.flash_bwd_dq_reference(*args)
        want_dk, want_dv = fa.flash_bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        tag = f"flash_bwd B={b} S_q={s_q} S_k={s_k} H={h} " \
              f"causal={causal} q_offset={q_off} D={d} strided={strided} " \
              f"{dtype}"
        _, (g_atol, g_rtol) = _flash_tolerances(dtype)

        def close(name, got, want):
            return check_close(f"{tag} {name}", got, want, g_atol(want),
                               g_rtol)

        err = {"dq": close("dq", dq, want_dq),
               "dkv": max(close("dk", dk, want_dk), close("dv", dv, want_dv))}
        del want_dq, want_dk, want_dv
        visible = _visible(s_q, s_k, causal, q_off)
        pairs = b * int(visible.sum())
        # Each input read once, each output written once: q, k, v, dO and
        # f32 lse, delta in; dq (or dk and dv) out.
        size = q.element_size()
        read = size * b * (2 * s_q + 2 * s_k) * h * d + 8.0 * b * s_q * h
        work = {"dq": (3 * 2.0 * d * h * pairs,
                       read + size * b * s_q * h * d),
                "dkv": (4 * 2.0 * d * h * pairs,
                        read + 2.0 * size * b * s_k * h * d)}
        kernel = {"dq": lambda: fa.flash_bwd_dq(*args),
                  "dkv": lambda: fa.flash_bwd_dkv(*args)}
        plain = {"dq": lambda: fa.flash_bwd_dq_reference(*args),
                 "dkv": lambda: fa.flash_bwd_dkv_reference(*args)}
        # The yardstick: the library's whole backward (dq, dk and dv) over
        # a graph built once.
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dout_t = dout.transpose(1, 2).contiguous()
        lib_out = _sdpa(causal, q_off, visible)(qt, kt, vt)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dout_t, retain_graph=True))
        for name in ("dq", "dkv"):
            flops, nbytes = work[name]
            bound_ms, bound_by = bound(flops, nbytes, _peak_flops(dtype))
            if dtype == torch.bfloat16:
                worst[name] = max(worst[name], err[name])
            row = dict(
                kernel=f"flash_bwd_{name}", shape=[b, s_q, h, d], s_k=s_k,
                causal=causal, q_offset=q_off, strided=strided,
                dtype=str(dtype).removeprefix("torch."),
                route=_flash_route(d, dtype), max_abs_err=err[name],
                kernel_ms=time_ms(kernel[name]),
                plain_ms=time_ms(plain[name]), library_ms=library_ms,
                library_computes="dq, dk and dv", bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=nbytes)
            row["share_of_bound"] = bound_ms / row["kernel_ms"]
            emit("flash_bwd", **row)
            if _is_main(row_key):
                main[name] = row
        del lib_out, q, k, v, dout, qt, kt, vt, dout_t, dq, dk, dv
    for name in main:
        main[name]["max_abs_err"] = worst[name]
    return main["dq"], main["dkv"]


def phase_rmsnorm() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import rmsnorm as rn
    from horovod_tpu_torch.utils import trace

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    e = 768
    scale = 1.0 + 0.1 * torch.randn(e, generator=gen, device="cuda")
    worst, main = 0.0, None
    lib_fn = getattr(F, "rms_norm", None)
    # The least a call can take: one empty launch, timed the same way.
    launch_floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    for dtype, n in RMS_CASES:
        x = torch.randn(n, e, generator=gen, device="cuda", dtype=dtype)
        y = rn.rms_norm(x, scale)
        ref = rn.rms_norm_reference(x, scale)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        tag = f"rmsnorm {str(dtype)[6:]} N={n}"
        err = check_close(tag, y, ref, RMS_ATOL,
                          BF16_RTOL if bf16 else RMS_F32_RTOL)
        if bf16:
            worst = max(worst, err)
        # One call, one kernel, of the form the shape picks: bf16 rows of
        # 768 in registers, f32 rows of 768 (3 KB) in the loop.
        form = "rmsnorm_fwd_regs_kernel" if bf16 else "rmsnorm_fwd_kernel"
        names = trace.kernels_in_one_call(lambda: rn.rms_norm(x, scale))
        if len(names) != 1 or form not in names[0]:
            raise AssertionError(f"{tag}: one call ran {names}")
        nbytes = 2.0 * n * e * x.element_size() + 4.0 * e
        flops = 4.0 * n * e   # square-accumulate, normalise, scale
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_CUDA_CORE_FLOPS)
        scale_x = scale.to(x.dtype)
        lib = (lambda t: lib_fn(t, (e,), scale_x, 1e-6)) if lib_fn else None
        fns = {"kernel_ms": lambda t: rn.rms_norm(t, scale),
               "plain_ms": lambda t: rn.rms_norm_reference(t, scale),
               "library_ms": lib}

        def times(timer):
            return {k: timer(f) if f else None for k, f in fns.items()}

        # Back to back, as the other kernels are timed: a call's x and y
        # stay in L2.
        row = dict(shape=[n, e], dtype=str(dtype)[6:], max_abs_err=err,
                   **times(lambda f: time_ms(lambda: f(x))),
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes, kernels_per_call=names,
                   launch_floor_ms=launch_floor_ms, share_of_bound=None)
        if nbytes >= RMS_HBM_MIN_BYTES:
            # Each call on its own x and y, over sets at least twice L2:
            # the bytes come from and go to HBM, as the bound assumes.
            sets = [x] + [torch.randn(n, e, generator=gen, device="cuda",
                                      dtype=dtype)
                          for _ in range(math.ceil(2 * L2_BYTES / nbytes))]
            hbm = times(lambda f: time_cold_ms(f, sets))
            # What the card takes to move the same bytes: x read, a copy
            # of it written.
            hbm["copy_ms"] = time_cold_ms(torch.clone, sets)
            row.update(hbm=dict(hbm, sets=len(sets)),
                       share_of_bound=bound_ms / hbm["kernel_ms"])
            del sets
        emit("rmsnorm", **row)
        if bf16 and n == RMS_MAIN:
            # The kernels line takes the HBM times, the bound's terms.
            main = dict(row, **row["hbm"])
    main["max_abs_err"] = worst
    return main


def phase_rmsnorm_bwd() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import rmsnorm as rn
    from horovod_tpu_torch.utils import trace

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    scales = {}
    worst, main = 0.0, None
    lib_fn = getattr(F, "rms_norm", None)
    for n, e in RMS_BWD_CASES:
        if e not in scales:
            scales[e] = 1.0 + 0.1 * torch.randn(e, generator=gen,
                                                device="cuda")
        scale = scales[e]
        x, dy = (torch.randn(n, e, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        dx, dscale = rn.rms_norm_backward(x, scale, dy)
        want_dx, want_dscale = rn.rms_norm_backward_reference(x, scale, dy)
        torch.cuda.synchronize()
        # One call, one kernel: the cross-block sum of dscale included.
        names = trace.kernels_in_one_call(
            lambda: rn.rms_norm_backward(x, scale, dy))
        if len(names) != 1 or "rmsnorm_bwd" not in names[0]:
            raise AssertionError(f"rmsnorm_bwd N={n} E={e}: one call ran "
                                 f"{names}")
        err = max(check_close(f"rmsnorm_bwd N={n} E={e} dx", dx, want_dx,
                              RMS_ATOL, BF16_RTOL),
                  check_close(f"rmsnorm_bwd N={n} E={e} dscale", dscale,
                              want_dscale,
                              DSCALE_ATOL_PER_SQRT_ROW * n ** 0.5, 1e-5))
        worst = max(worst, err)
        # bf16 x, dy in and dx out, f32 scale in and dscale out.
        nbytes = 2.0 * n * e * 3 + 8.0 * e
        # x^2 sum, g = dy*scale, x^ = x*r, g*x^ sum, dx, dscale sum.
        flops = 11.0 * n * e
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_CUDA_CORE_FLOPS)
        library_ms = None
        if lib_fn is not None:
            xl = x.detach().requires_grad_()
            wl = scale.to(x.dtype).requires_grad_()
            yl = lib_fn(xl, (e,), wl, 1e-6)
            library_ms = time_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True))
        row = dict(
            shape=[n, e], max_abs_err=err,
            kernel_ms=time_ms(lambda: rn.rms_norm_backward(x, scale, dy)),
            plain_ms=time_ms(lambda: rn.rms_norm_backward_reference(
                x, scale, dy)),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes, kernels_per_call=names)
        emit("rmsnorm_bwd", **row)
        if (n, e) == (RMS_MAIN, 768):
            main = row
    main["max_abs_err"] = worst
    return main


def phase_serve() -> dict:
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      config_162m)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.flash_attention import (
        flash_attention_reference)
    from horovod_tpu_torch.serving import loadgen
    from horovod_tpu_torch.serving.engine import (ServingConfig,
                                                  ServingEngine,
                                                  TransformerBackend)

    scfg = ServingConfig(num_slots=8, buckets=(128, 256, 512, 1024),
                         max_seq_len=2048)
    mcfg = config_162m(max_seq_len=scfg.max_seq_len)
    t0 = time.monotonic()
    model = Transformer(mcfg, device="cuda")
    model.load_state_dict(init_params(mcfg, SEED))
    n_params = sum(p.numel() for p in model.parameters())
    backend = TransformerBackend(model, scfg.num_slots, scfg.max_seq_len)
    setup_s = time.monotonic() - t0

    # Warm-up: one short request, so the measured run does not pay the
    # first cuBLAS / allocator calls.
    warm = ServingEngine(backend, scfg)
    warm.submit(list(range(1, 101)), 2)
    warm.run_until_idle()

    rng = np.random.default_rng(SEED)
    lens = rng.integers(100, 1001, size=16)
    prompts = [list(map(int, rng.integers(1, mcfg.vocab_size, size=n)))
               for n in lens]
    new_tokens = 32
    eng = ServingEngine(backend, scfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = eng.clock()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = eng.clock() - t0
    launches = _launches()
    prefills, steps = eng.counters["admitted"], eng.counters["steps"]

    if len(done) != len(reqs) or any(
            r.finish_reason != "max_new_tokens"
            or len(r.tokens) != new_tokens for r in reqs):
        raise AssertionError("not every request finished with "
                             f"{new_tokens} new tokens")
    if launches["flash_fwd"] != prefills * mcfg.num_layers:
        raise AssertionError(f"flash launches {launches['flash_fwd']} != "
                             f"prefills {prefills} x {mcfg.num_layers}")
    norms = 2 * mcfg.num_layers + 1
    if launches["rmsnorm_fwd"] < norms * (prefills + steps):
        raise AssertionError(f"rmsnorm launches {launches['rmsnorm_fwd']} "
                             f"< {norms} x (prefills + decode steps)")
    rep = loadgen.report(done, wall, offered=len(reqs))

    # One prefill again, through the kernels and through the plain
    # versions on the card, with the same weights.
    plain_cfg = dataclasses.replace(
        mcfg, fused_norm=False,
        attention_fn=lambda q, k, v, causal=True: flash_attention_reference(
            q, k, v, causal)[0])
    plain = Transformer(plain_cfg, device="cuda")
    plain.load_state_dict(model.state_dict())
    prompt = prompts[0]
    bucket = next(b for b in scfg.buckets if b >= len(prompt))
    toks = torch.zeros(1, bucket, dtype=torch.long, device="cuda")
    toks[0, :len(prompt)] = torch.tensor(prompt, device="cuda")
    with torch.inference_mode():
        got = model(toks)[0, len(prompt) - 1].float()
        want = plain(toks)[0, len(prompt) - 1].float()
    if not torch.isfinite(got).all() or got.shape != (mcfg.vocab_size,):
        raise AssertionError("prefill logits are not finite [vocab]")
    dlogits = (got - want).abs().max().item()
    argmax_ok = int(got.argmax()) == int(want.argmax()) == reqs[0].tokens[0]
    if not argmax_ok or dlogits > LOGITS_ATOL:
        raise AssertionError(
            f"162M prefill: kernels vs plain argmax match {argmax_ok}, "
            f"max |dlogits| {dlogits} (bound {LOGITS_ATOL})")
    emit("serve", model="162M decoder (12 x 768, 6 heads of 128, vocab "
         "32000, bf16 compute / f32 params)", params=n_params,
         setup_s=setup_s, requests=len(reqs), prompt_lens=[int(n)
                                                          for n in lens],
         new_tokens=new_tokens, prefills=prefills, decode_steps=steps,
         launches=launches, ttft_p50_ms=rep["ttft_p50_ms"],
         ttft_p99_ms=rep["ttft_p99_ms"], token_p50_ms=rep["token_p50_ms"],
         token_p99_ms=rep["token_p99_ms"],
         tokens_per_s=rep["tokens_per_s"], wall_s=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         plain_max_abs_dlogits=dlogits, plain_argmax_match=argmax_ok)
    return launches, model


def _serve_config(**kw):
    from horovod_tpu_torch.serving.engine import ServingConfig

    return ServingConfig(num_slots=8, buckets=(128, 256, 512, 1024),
                         max_seq_len=2048, record_logits=True, **kw)


def _launches() -> dict:
    from horovod_tpu_torch.ops import _build

    return {name: k.launches for name, k in _build.KERNELS.items()}


def _run_counted(eng, prompts, new_tokens: int, after_first_step=None):
    """Submit every prompt at once and drain the engine, with the kernels'
    launch counts set to 0 just before and read just after; each request
    must finish with ``new_tokens`` tokens.  ``after_first_step`` runs
    once the first wave is admitted.  Returns the requests, the launches
    and the wall seconds."""
    from horovod_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = eng.clock()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.step()
    if after_first_step is not None:
        after_first_step()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = eng.clock() - t0
    launches = _launches()
    if any(r.finish_reason != "max_new_tokens"
           or len(r.tokens) != new_tokens for r in reqs):
        raise AssertionError(f"not every request finished with {new_tokens} "
                             "new tokens")
    return reqs, launches, wall


def _check_cache_path(tag, launches, calls: int, norms: int) -> None:
    """The cache path of the model: the RMSNorm kernel ``norms`` times (25
    for the 162M) a prefill, decode or verify call, and never the flash
    kernel."""
    if launches["flash_fwd"] != 0:
        raise AssertionError(f"{tag}: {launches['flash_fwd']} flash launches "
                             "on the paged path (0 expected)")
    if launches["rmsnorm_fwd"] < norms * calls:
        raise AssertionError(f"{tag}: rmsnorm launches "
                             f"{launches['rmsnorm_fwd']} < {norms} x {calls} "
                             "calls")


def compare_streams(tag, got, want) -> dict:
    """``got``'s token streams against ``want``'s, request by request.  A
    stream may leave ``want``'s only at a position where ``want``'s two
    largest logits are within :data:`LOGITS_ATOL` of each other (a near
    tie that one rounding of bf16 activations can flip), and up to and at
    that position every row of logits must be within :data:`LOGITS_ATOL`
    of ``want``'s."""
    identical, rows, bitwise, worst = 0, 0, 0, 0.0
    for g, w in zip(got, want, strict=True):
        for j, (gl, wl) in enumerate(zip(g.logits, w.logits)):
            d = float(np.abs(gl - wl).max())
            worst, rows = max(worst, d), rows + 1
            bitwise += bool(np.array_equal(gl, wl))
            if d > LOGITS_ATOL:
                raise AssertionError(f"{tag}: request {g.rid} position {j}: "
                                     f"max |dlogits| {d} > {LOGITS_ATOL}")
            if g.tokens[j] != w.tokens[j]:
                lo, hi = np.partition(wl, -2)[-2:]
                if hi - lo > LOGITS_ATOL:
                    raise AssertionError(
                        f"{tag}: request {g.rid} diverges at position {j} "
                        f"where the top-two gap is {hi - lo}")
                break
        else:
            if g.tokens != w.tokens:
                raise AssertionError(f"{tag}: request {g.rid} streams differ")
            identical += 1
    return {"identical_streams": identical, "streams": len(want),
            "bitwise_logit_rows_share": bitwise / rows,
            "max_abs_dlogits": worst}


def _prefix_pages(eng, prefix) -> list[int]:
    """Page ids of ``prefix``'s chunks in the engine's prefix trie."""
    node, pids, ps = eng.prefix._root, [], eng.prefix.page_size
    for off in range(0, len(prefix), ps):
        node = node.children[tuple(prefix[off:off + ps])]
        pids.append(node.pid)
    return pids


def _gather_scatter_ms(backend, lengths) -> dict:
    """Device ms of the paged decode step's gather of every slot's row and
    its scatter of one position a slot, on the backend's pool (the
    scatter writes back the values it gathered)."""
    tables = backend.page_tables
    start = torch.as_tensor(np.maximum(lengths - 1, 0), device="cuda")
    with torch.inference_mode():
        kd, vd = backend._gather(tables)
        return {"gather_ms": time_ms(lambda: backend._gather(tables)),
                "scatter_ms": time_ms(lambda: backend._scatter(
                    tables, kd, vd, start, 1))}


def _teacher_forced(backend, cfg, prompts, want, k: int, verify: bool):
    """Prefill ``prompts`` (one a slot, every slot) into fresh page rows of
    ``backend``, then feed each slot ``want``'s own tokens 0 .. k+1: as
    k+2 decode steps, or as one verify block of tokens 0 .. k (every draft
    ``want``'s greedy token, so every one is accepted but at a near tie)
    and one decode step, which reads the block's K/V back from the pages.
    Returns each ``(slot, position)``'s predicted token and logits, and
    the K/V the pages hold at the k+2 fed positions, ``[L, slots, k+2, H,
    D]`` in f32."""
    pps = backend.pages_per_slot
    n = np.array([len(p) for p in prompts])
    out = {}
    for t in (backend.pk, backend.pv):      # nothing of an earlier pass
        t[:, 1:1 + len(prompts) * pps] = 0
    for s, p in enumerate(prompts):
        backend.attach_slot(s, list(range(1 + s * pps, 1 + (s + 1) * pps)))
        padded = np.zeros((1, next(b for b in cfg.buckets if b >= len(p))),
                          np.int32)
        padded[0, :len(p)] = p
        out[s, 0] = backend.prefill_prefixed(padded, len(p), s, 0)
    toks = np.array([w.tokens[:k + 2] for w in want], np.int32)
    steps = []
    if verify:
        preds, rows = backend.verify(toks[:, :k + 1], n + 1)
        steps += [(j + 1, preds[:, j], rows[:, j]) for j in range(k + 1)]
        steps.append((k + 2, *backend.decode(toks[:, k + 1], n + k + 2)))
    else:
        steps += [(j + 1, *backend.decode(toks[:, j], n + 1 + j))
                  for j in range(k + 2)]
    for j, preds, rows in steps:
        for s in range(len(prompts)):
            out[s, j] = int(preds[s]), rows[s]
    with torch.inference_mode():
        kv = [torch.stack([t[:, s, n[s]:n[s] + k + 2]
                           for s in range(len(prompts))], 1).float()
              for t in backend._gather(backend.page_tables)]
    for s in range(len(prompts)):
        backend.release_slot(s)
    return out, kv


def check_verify_block(backend, cfg, prompts, want, k: int) -> dict:
    """Speculation with every draft accepted, against ``want`` (the
    cache-off run) and against plain decode steps on the same pages.  The
    logits of the verify block and of the decode step after it are within
    :data:`LOGITS_ATOL` of ``want``'s, and every token is ``want``'s but at
    a near tie (the drafts are ``want``'s own tokens); the K/V that the
    block's columns 1 .. k wrote to their pages, read back by the decode,
    equal what k+1 decode steps write there within :data:`KV_REL_L2`."""
    runs = [_teacher_forced(backend, cfg, prompts, want, k, verify)
            for verify in (False, True)]
    worst, ties = 0.0, 0
    for out, _ in runs:
        for (s, j), (tok, row) in out.items():
            wl = want[s].logits[j]
            d = float(np.abs(row - wl).max())
            worst = max(worst, d)
            if d > LOGITS_ATOL:
                raise AssertionError(f"verify block: slot {s} position {j}:"
                                     f" max |dlogits| {d} > {LOGITS_ATOL}")
            if tok != want[s].tokens[j]:
                lo, hi = np.partition(wl, -2)[-2:]
                if hi - lo > LOGITS_ATOL:
                    raise AssertionError(
                        f"verify block: slot {s} position {j}: token {tok} "
                        f"!= {want[s].tokens[j]}, top-two gap {hi - lo}")
                ties += 1
    accepted = sum(runs[1][0][s, j][0] == want[s].tokens[j]
                   for s in range(len(prompts)) for j in range(1, k + 1))
    rel = max(float(((b - a).norm(dim=(-2, -1))
                     / a.norm(dim=(-2, -1))).max())
              for a, b in zip(runs[0][1], runs[1][1]))
    if rel > KV_REL_L2:
        raise AssertionError(f"verify block: K/V in the pages off plain "
                             f"decode's by {rel} (rel. L2) > {KV_REL_L2}")
    return {"drafts": k * len(prompts), "accepted": int(accepted),
            "near_tie_tokens": ties, "max_abs_dlogits": worst,
            "kv_rel_l2_max": rel}


class _ColdPrefixCache:
    """Wraps an engine's prefix cache so that every lookup misses: each
    admission then prefills its whole prompt into pages of its own, and
    none reads another's (``cache_pages=0`` alone still lets a slot attach
    to the pages of a live or a released donor)."""

    def __init__(self, inner):
        self.inner = inner

    def lookup(self, prompt) -> int:
        return 0

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_serve_paged(model) -> dict:
    """The 162M on ``PagedTransformerBackend``: shared-prefix traffic
    through (a) the cache, (b) the cache off, (c) the cache and
    speculation."""
    from horovod_tpu_torch.serving import loadgen
    from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                                  ServingEngine,
                                                  TransformerBackend)

    t_phase = time.monotonic()
    cfg = _serve_config()
    vocab = model.cfg.vocab_size

    def paged(cache_pages):
        return PagedTransformerBackend(model, cfg.num_slots, cfg.max_seq_len,
                                       cache_pages=cache_pages,
                                       page_size=PAGE_SIZE)

    w = loadgen.Workload(qps=1.0, duration_s=60.0, seed=SEED,
                         prompt_lens=tuple(range(100, 401)),
                         short_new=PAGED_NEW, long_new=PAGED_NEW,
                         vocab=vocab, shared_frac=0.75,
                         shared_prefix_len=PAGED_SHARED_LEN)
    prompts = [p for _, p, _ in loadgen.make_arrivals(w)][:PAGED_REQUESTS]
    if len(prompts) != PAGED_REQUESTS:
        raise AssertionError(f"the workload made {len(prompts)} requests")
    heads = collections.Counter(tuple(p[:PAGED_SHARED_LEN]) for p in prompts)
    shared, n_shared = heads.most_common(1)[0]

    backend = paged(PAGED_CACHE_PAGES)
    warm = ServingEngine(backend, cfg)
    warm.submit(list(range(1, 101)), 2)
    warm.run_until_idle()
    pool_bytes = 2 * backend.pk.numel() * backend.pk.element_size()

    pages = {}

    def snapshot():
        # The shared prefix's pages as its donor's prefill wrote them.
        pages["pids"] = _prefix_pages(eng, shared)
        pages["bits"] = [t[:, pages["pids"]].clone()
                         for t in (backend.pk, backend.pv)]

    runs, cold = {}, paged(0)
    norms = 2 * model.cfg.num_layers + 1
    for run, make in (
            ("a", lambda: ServingEngine(backend, cfg)),
            ("b", lambda: ServingEngine(cold, cfg)),
            ("c", lambda: ServingEngine(
                backend, dataclasses.replace(cfg, spec_k=PAGED_SPEC_K))),
            ("d", lambda: ServingEngine(TransformerBackend(
                model, cfg.num_slots, cfg.max_seq_len), cfg))):
        eng = make()
        if run == "b":
            eng.prefix = _ColdPrefixCache(eng.prefix)
        torch.cuda.reset_peak_memory_stats()
        reqs, launches, wall = _run_counted(
            eng, prompts, PAGED_NEW, snapshot if run == "a" else None)
        st = eng.stats()
        calls = st["admitted"] + st["steps"]
        if run != "d":
            _check_cache_path(f"serve_paged ({run})", launches, calls, norms)
        elif (launches["flash_fwd"] != st["admitted"] * model.cfg.num_layers
              or launches["rmsnorm_fwd"] < norms * calls):
            raise AssertionError(f"serve_paged (d): launches {launches} for "
                                 f"{st['admitted']} prefills, {calls} calls")
        runs[run] = dict(reqs=reqs, launches=launches, stats=st, wall=wall,
                         calls=calls, peak=torch.cuda.max_memory_allocated())
        if run == "a" and not (_prefix_pages(eng, shared) == pages["pids"]
                               and all(torch.equal(t[:, pages["pids"]], b)
                                       for t, b in zip((backend.pk,
                                                        backend.pv),
                                                       pages["bits"]))):
            raise AssertionError("serve_paged: the shared prefix pages "
                                 "changed after their first write")

    a, b, c = runs["a"]["stats"], runs["b"]["stats"], runs["c"]["stats"]
    if not a["prefix_hits"] or a["prefix_hit_tokens"] % PAGE_SIZE:
        raise AssertionError(f"serve_paged: prefix hits {a['prefix_hits']}, "
                             f"hit tokens {a['prefix_hit_tokens']}")
    if b["prefix_hits"]:
        raise AssertionError("serve_paged (b): the cache-off run hit")
    vs_a = compare_streams("serve_paged (a) vs (b)", runs["a"]["reqs"],
                           runs["b"]["reqs"])
    vs_c = compare_streams("serve_paged (c) vs (b)", runs["c"]["reqs"],
                           runs["b"]["reqs"])
    vs_d = compare_streams("serve_paged (d) vs (b)", runs["d"]["reqs"],
                           runs["b"]["reqs"])
    verify_block = check_verify_block(cold, cfg, prompts[:cfg.num_slots],
                                      runs["b"]["reqs"][:cfg.num_slots],
                                      PAGED_SPEC_K)
    lengths = np.array([len(p) for p in prompts[:cfg.num_slots]])
    tokens = PAGED_REQUESTS * PAGED_NEW
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["a"]["launches"]}
    emit("serve_paged", requests=PAGED_REQUESTS, new_tokens=PAGED_NEW,
         shared_prefix_len=PAGED_SHARED_LEN, shared_prompts=n_shared,
         prompt_lens=[len(p) for p in prompts], page_size=PAGE_SIZE,
         cache_pages=PAGED_CACHE_PAGES, pool_bytes=pool_bytes,
         max_memory_allocated={k: r["peak"] for k, r in runs.items()},
         calls={k: r["calls"] for k, r in runs.items()},
         launches_by_run={k: r["launches"] for k, r in runs.items()},
         prefix_hits=a["prefix_hits"],
         prefix_hit_tokens=a["prefix_hit_tokens"],
         prefix_hit_rate=a["prefix_hit_rate"], shared_pages_unchanged=True,
         ttft_ms={k: [r["stats"]["ttft_p50_ms"], r["stats"]["ttft_p99_ms"]]
                  for k, r in runs.items()},
         token_ms={k: [r["stats"]["token_p50_ms"],
                       r["stats"]["token_p99_ms"]] for k, r in runs.items()},
         tokens_per_s={k: tokens / r["wall"] for k, r in runs.items()},
         spec=dict(spec_k=PAGED_SPEC_K, token_p50_ms=c["token_p50_ms"],
                   token_p99_ms=c["token_p99_ms"],
                   prefix_hit_rate=c["prefix_hit_rate"],
                   spec_accept_rate=c["spec_accept_rate"],
                   steps=c["steps"], steps_without=a["steps"]),
         a_vs_b=vs_a, c_vs_b=vs_c, d_vs_b=vs_d, verify_block=verify_block,
         decode_gather_scatter=_gather_scatter_ms(backend, lengths),
         seconds=time.monotonic() - t_phase)
    return launches


def phase_router(chat_model) -> dict:
    """Two 162M models behind one ``Router`` on the card: ``chat`` on the
    paged backend (seed ``SEED``), ``code`` on the dense one (seed ``SEED +
    1``)."""
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.serving.autoscale import AutoscaleConfig
    from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                                  ServingEngine,
                                                  TransformerBackend)
    from horovod_tpu_torch.serving.router import (ModelSpec, Router,
                                                  RouterAutoscaler)

    t_phase = time.monotonic()
    cfg = _serve_config()
    mcfg = chat_model.cfg
    code_model = Transformer(mcfg, device="cuda")
    code_model.load_state_dict(init_params(mcfg, SEED + 1))
    chat = PagedTransformerBackend(chat_model, cfg.num_slots,
                                   cfg.max_seq_len,
                                   cache_pages=PAGED_CACHE_PAGES,
                                   page_size=PAGE_SIZE)
    code = TransformerBackend(code_model, cfg.num_slots, cfg.max_seq_len)
    for backend in (chat, code):            # first cuBLAS calls
        warm = ServingEngine(backend, cfg)
        warm.submit(list(range(1, 101)), 2)
        warm.run_until_idle()

    rng = np.random.default_rng(SEED + 2)
    prompts = {m: [list(map(int, rng.integers(1, mcfg.vocab_size, size=n)))
                   for n in rng.integers(100, 401, size=ROUTER_REQUESTS)]
               for m in ("chat", "code")}
    specs = [ModelSpec(m, slo_ttft_ms=ROUTER_SLO_MS) for m in prompts]
    engines = {m: ServingEngine(be, cfg, tick_name=f"serving.tick.{m}")
               for m, be in (("chat", chat), ("code", code))}
    router = Router()
    for spec in specs:
        router.add_model(spec, [engines[spec.name]])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.monotonic()
    reqs = {m: [router.submit(m, p, ROUTER_NEW) for p in ps]
            for m, ps in prompts.items()}
    done = router.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launches()
    for m in prompts:
        if {id(r) for r in done.get(m, ())} != {id(r) for r in reqs[m]}                 or any(len(r.tokens) != ROUTER_NEW for r in reqs[m]):
            raise AssertionError(f"router: not every {m} request completed "
                                 f"on its model with {ROUTER_NEW} tokens")
    calls = {m: e.counters["admitted"] + e.counters["steps"]
             for m, e in engines.items()}
    code_prefills = engines["code"].counters["admitted"]
    if launches["flash_fwd"] != code_prefills * mcfg.num_layers:
        raise AssertionError(f"router: flash launches {launches['flash_fwd']}"
                             f" != code's prefills {code_prefills} x "
                             f"{mcfg.num_layers}")
    norms = 2 * mcfg.num_layers + 1
    if launches["rmsnorm_fwd"] < norms * sum(calls.values()):
        raise AssertionError(f"router: rmsnorm launches "
                             f"{launches['rmsnorm_fwd']} < {norms} x {calls}")
    stats = router.stats()
    verdict = RouterAutoscaler(specs, budget=len(specs),
                               config=AutoscaleConfig.from_env()).decide(
                                   router)

    alone = []
    for p in prompts["chat"]:
        eng = ServingEngine(chat, cfg)
        alone.append(eng.submit(p, ROUTER_NEW))
        eng.run_until_idle()
    vs_alone = compare_streams("router chat vs alone", reqs["chat"], alone)
    emit("router", models={m: f"162M, seed {SEED + i}, "
                           f"{type(engines[m].backend).__name__}"
                           for i, m in enumerate(prompts)},
         requests_per_model=ROUTER_REQUESTS, new_tokens=ROUTER_NEW,
         prompt_lens={m: [len(p) for p in ps] for m, ps in prompts.items()},
         tick_names={m: e.tick_name for m, e in engines.items()},
         launches=launches, calls=calls, wall_s=wall, stats=stats,
         autoscale_verdict=verdict, chat_vs_alone=vs_alone,
         seconds=time.monotonic() - t_phase)
    return launches


@contextlib.contextmanager
def record_norm_rows(seen: set):
    """Add ``(dtype, rows, width)`` of every RMSNorm forward kernel
    launch to ``seen``."""
    from horovod_tpu_torch.ops import rmsnorm as rn

    launch = rn._rms_norm_cuda

    def recorded(x, scale, eps):
        seen.add((x.dtype, x.numel() // x.shape[-1], x.shape[-1]))
        return launch(x, scale, eps)

    rn._rms_norm_cuda = recorded
    try:
        yield
    finally:
        rn._rms_norm_cuda = launch


def check_norm_rows(seen: set) -> None:
    """Every shape a main path gave the RMSNorm forward kernel is one
    that ``phase_rmsnorm`` held against the plain version."""
    checked = {(dt, n, 768) for dt, n in RMS_CASES}
    unchecked = sorted((str(dt), n, e) for dt, n, e in seen - checked)
    emit("rmsnorm_rows", main_paths=sorted((str(dt), n, e)
                                           for dt, n, e in seen),
         unchecked=unchecked)
    if unchecked:
        raise AssertionError(f"the RMSNorm forward ran at {unchecked}, "
                             "which phase_rmsnorm does not check")


@contextlib.contextmanager
def plain_versions():
    """Run every kernel's plain PyTorch version on the card instead of the
    kernel: the wrappers pick their route by ``_on_cuda``."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import rmsnorm as rn

    saved = fa._on_cuda, rn._on_cuda
    fa._on_cuda = rn._on_cuda = lambda t: False
    try:
        yield
    finally:
        fa._on_cuda, rn._on_cuda = saved


def step_vs_plain(model, tokens) -> dict:
    """One training step's loss and gradients through the kernels against
    the same step through the plain versions, at the same weights."""
    from horovod_tpu_torch import train_transformer as tt

    runs = []
    for route in (contextlib.nullcontext, plain_versions):
        model.zero_grad(set_to_none=True)
        with route():
            loss = tt.loss_fn(model, tokens)
            loss.backward()
        runs.append((float(loss.detach()),
                     {n: p.grad.float() for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (loss_k, g_k), (loss_p, g_p) = runs
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm()).item()
           for n in g_k}
    worst = max(rel, key=rel.get)
    return {"kernel_loss": loss_k, "plain_loss": loss_p,
            "loss_diff": abs(loss_k - loss_p),
            "finite": all(bool(torch.isfinite(g).all())
                          for g in g_k.values()),
            "grad_rel_l2_max": rel[worst], "worst_param": worst,
            "grad_rel_l2_median": float(np.median(list(rel.values())))}


def phase_train() -> dict:
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.schedule_plan import overlap_plan
    from horovod_tpu_torch.utils import trace

    basics.init()   # NCCL, world 1: the reduce is the identity
    try:
        dev = basics.device()
        cfg = tt.train_config()
        model, opt = tt.make_trainer(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        tokens = tt.token_batch(cfg.vocab_size, dev)
        # One step's gradients at the seeded weights and the batch,
        # through the kernels against the plain versions: in bf16 (the
        # step as it trains) and in f32 (where the roundings that the two
        # routes take apart are 2**16 times finer).  Taken before
        # training: a few steps memorise the fixed batch, and the
        # gradients of a near-zero loss are mostly rounding.
        checks = {"bf16": step_vs_plain(model, tokens)}
        f32_cfg = tt.train_config(dtype=torch.float32,
                                  logits_dtype=torch.float32)
        f32_model = Transformer(f32_cfg, device=dev)
        f32_model.load_state_dict(model.state_dict())
        checks["f32"] = step_vs_plain(f32_model, tokens)
        del f32_model
        for name, bounds in (("bf16", (TRAIN_LOSS_ATOL, TRAIN_GRAD_REL_L2)),
                             ("f32", (TRAIN_F32_LOSS_ATOL,
                                      TRAIN_F32_GRAD_REL_L2))):
            c = checks[name]
            if not c["finite"] or c["loss_diff"] > bounds[0] \
                    or c["grad_rel_l2_max"] > bounds[1]:
                raise AssertionError(f"{name} train step, kernels vs plain "
                                     f"versions: {c}, bounds {bounds}")
        model.zero_grad(set_to_none=True)
        losses, step_s, launches, peak = _timed_steps(model, opt, tokens)
        per_step = _per_step(cfg)
        _check_steps("train", losses, launches, per_step)

        plan = overlap_plan()
        if not _is_bypass(plan):
            raise AssertionError(f"train overlap plan at world 1: {plan}")

        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "train_step", lambda: tt.train_step(model, opt, tokens), 3,
                tmp)

        tok_s = tt.BATCH * tt.SEQ_LEN / step_s
        emit("train", model="162M decoder (12 x 768, 6 heads of 128, vocab "
             "32000, bf16 compute / f32 params, bf16 logits)",
             params=n_params, batch=tt.BATCH, seq_len=tt.SEQ_LEN,
             processes=basics.size(),
             backend=torch.distributed.get_backend(), losses=losses,
             step_ms=step_s * 1e3, tok_per_s=tok_s,
             mfu=tok_s * tt.flops_per_token(n_params, cfg, tt.SEQ_LEN)
             / PEAK_BF16_FLOPS,
             launches=launches, launches_per_step=per_step,
             max_memory_allocated=peak, breakdown=breakdown,
             step_vs_plain=checks, overlap_plan=plan)
    finally:
        basics.shutdown()
    return {"launches": launches, "step_ms": step_s * 1e3,
            "max_memory_allocated": peak, "breakdown": breakdown}


def _timed_steps(model, opt, tokens, accumulate: int = 1):
    """``WARMUP_STEPS`` + ``TIMED_STEPS`` training steps from zeroed
    launch counts and peak memory: the losses, the timed steps' mean time
    (host clock, ending in a synchronize), the launches of every kernel
    over all the steps, and the peak memory."""
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses = [tt.train_step(model, opt, tokens, accumulate)
              for _ in range(tt.WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tt.train_step(model, opt, tokens, accumulate)
               for _ in range(tt.TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / tt.TIMED_STEPS
    launches = _launches()
    return ([float(x) for x in losses], step_s, launches,
            torch.cuda.max_memory_allocated())


def _per_step(cfg, accumulate: int = 1) -> dict:
    """Each kernel's launches in one 162M step: a flash forward, dq and
    dk/dv per layer and 2L + 1 norms, forward and backward; under remat
    every block's forward (its flash forward and two norms) runs twice."""
    layers, norms = cfg.num_layers, 2 * cfg.num_layers + 1
    fwd, norm_fwd = (2 * layers, norms + 2 * layers) if cfg.remat else \
        (layers, norms)
    per = {"flash_fwd": fwd, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
           "rmsnorm_fwd": norm_fwd, "rmsnorm_bwd": norms}
    return {n: c * accumulate for n, c in per.items()}


def _check_steps(phase, losses, launches, per_step) -> None:
    from horovod_tpu_torch import train_transformer as tt

    steps = tt.WARMUP_STEPS + tt.TIMED_STEPS
    if launches != {n: steps * c for n, c in per_step.items()}:
        raise AssertionError(f"{phase} launches {launches} over {steps} "
                             f"steps, want {per_step} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} losses not finite and falling: "
                             f"{losses}")


def _grads_vs(model, ref_loss, ref_grads, loss) -> dict:
    """``model``'s ``.grad`` and ``loss`` against a reference step's."""
    rel = {n: ((p.grad.float() - ref_grads[n]).norm()
               / ref_grads[n].norm()).item()
           for n, p in model.named_parameters()}
    worst = max(rel, key=rel.get)
    return {"loss": loss, "ref_loss": ref_loss,
            "loss_diff": abs(loss - ref_loss),
            "bit_equal": all(torch.equal(p.grad.float(), ref_grads[n])
                             for n, p in model.named_parameters()),
            "finite": all(bool(torch.isfinite(p.grad).all())
                          for p in model.parameters()),
            "grad_rel_l2_max": rel[worst], "worst_param": worst}


def _within_train_bounds(phase, c) -> None:
    if not c["finite"] or c["loss_diff"] > TRAIN_LOSS_ATOL \
            or c["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2:
        raise AssertionError(f"{phase}: {c}, bounds {TRAIN_LOSS_ATOL}, "
                             f"{TRAIN_GRAD_REL_L2}")


def _one_step_grads(model, tokens):
    """The loss and each parameter's gradient (f32 copies) of one
    full-batch step, ``.grad`` zeroed after."""
    from horovod_tpu_torch import train_transformer as tt

    model.zero_grad(set_to_none=True)
    loss = tt.loss_fn(model, tokens)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


# Resident parameter against bf16(master): the JAX package's own bound
# (tests/test_training.py, test_master_weights_tracks_f32_training),
# |p - bf16(m)| <= MASTER_ATOL + MASTER_RTOL * |bf16(m)|.  The delta-add
# p + (bf16(m) - p) is exact where the subtraction is (Sterbenz); else the
# delta rounds to half an ulp of |delta| (an update, ~lr), which near zero
# is more than an ulp of the result but far inside MASTER_ATOL.
MASTER_RTOL, MASTER_ATOL = 0.008, 4e-5


def _resident_vs_master(opt) -> dict:
    """How far each resident parameter lies from bf16(its master): the
    share that is exact, the largest distance in bf16 ulps (bit patterns
    mapped to a monotone integer order), and whether every one is within
    the JAX package's bound."""
    mw = opt._opt
    resident = [p for g in mw.param_groups for p in g["params"]]

    def order(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    worst, worst_abs, exact, total, within = 0, 0.0, 0, 0, True
    for p, m in zip(resident, mw.masters()):
        b = m.to(p.dtype)
        d = (order(p.detach()) - order(b)).abs()
        diff = (p.detach().float() - b.float()).abs()
        worst = max(worst, int(d.max()))
        worst_abs = max(worst_abs, float(diff.max()))
        exact += int((d == 0).sum())
        total += d.numel()
        within &= bool((diff <= MASTER_ATOL
                        + MASTER_RTOL * b.float().abs()).all())
    return {"exact_share": exact / total, "max_ulps": worst,
            "max_abs_diff": worst_abs, "within_bound": within,
            "params": total}


def _train_row(phase, cfg, n_params, losses, step_s, launches, per_step,
               peak, **extra) -> None:
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt

    tok_s = tt.BATCH * tt.SEQ_LEN / step_s
    emit(phase, params=n_params, batch=tt.BATCH, seq_len=tt.SEQ_LEN,
         processes=basics.size(), param_dtype=str(cfg.param_dtype),
         remat=cfg.remat, losses=losses, step_ms=step_s * 1e3,
         tok_per_s=tok_s,
         mfu=tok_s * tt.flops_per_token(n_params, cfg, tt.SEQ_LEN)
         / PEAK_BF16_FLOPS, launches=launches, launches_per_step=per_step,
         max_memory_allocated=peak, **extra)


def phase_train_mixed(train: dict) -> dict:
    """The 162M step with ``--bf16-params``: bf16-resident parameters,
    ``DistributedOptimizer(master_weights(AdamW))``; after the steps every
    resident parameter must lie on bf16(master), within the JAX package's
    bound where the delta-add rounds."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.utils import trace

    basics.init()
    try:
        dev = basics.device()
        cfg = tt.train_config(param_dtype=torch.bfloat16)
        model, opt = tt.make_trainer(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        tokens = tt.token_batch(cfg.vocab_size, dev)
        losses, step_s, launches, peak = _timed_steps(model, opt, tokens)
        per_step = _per_step(cfg)
        _check_steps("train_mixed", losses, launches, per_step)
        ulps = _resident_vs_master(opt)
        if not ulps["within_bound"]:
            raise AssertionError(f"train_mixed: resident parameters off "
                                 f"bf16(master): {ulps}")
        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "train_mixed_step", lambda: tt.train_step(model, opt, tokens),
                3, tmp)
        _train_row("train_mixed", cfg, n_params, losses, step_s, launches,
                   per_step, peak, resident_vs_master=ulps,
                   breakdown=breakdown, train_breakdown=train["breakdown"],
                   train_max_memory_allocated=train["max_memory_allocated"],
                   train_step_ms=train["step_ms"])
    finally:
        basics.shutdown()
    return launches


def phase_train_remat(train: dict) -> dict:
    """The 162M step with ``--remat``: one step's gradients against the
    same step without remat (bit-equal, or within the train phase's bf16
    bounds with the parameter named), launches with every block's forward
    twice, and a peak memory below the ``train`` phase's."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.utils import trace

    basics.init()
    try:
        dev = basics.device()
        cfg = tt.train_config(remat=True)
        tokens = tt.token_batch(cfg.vocab_size, dev)
        plain = Transformer(tt.train_config(), device=dev)
        plain.load_state_dict(init_params(cfg, SEED))
        ref_loss, ref_grads = _one_step_grads(plain, tokens)
        remat = Transformer(cfg, device=dev)
        remat.load_state_dict(plain.state_dict())
        del plain
        remat.zero_grad(set_to_none=True)
        loss = tt.loss_fn(remat, tokens)
        loss.backward()
        check = _grads_vs(remat, ref_loss, ref_grads, float(loss.detach()))
        del remat, ref_grads, loss
        if not check["bit_equal"]:
            _within_train_bounds("train_remat, remat vs plain", check)
        model, opt = tt.make_trainer(cfg, dev, SEED)
        n_params = sum(p.numel() for p in model.parameters())
        losses, step_s, launches, peak = _timed_steps(model, opt, tokens)
        per_step = _per_step(cfg)
        _check_steps("train_remat", losses, launches, per_step)
        if not peak < train["max_memory_allocated"]:
            raise AssertionError(f"train_remat peak memory {peak} B, the "
                                 f"train phase's "
                                 f"{train['max_memory_allocated']} B")
        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "train_remat_step", lambda: tt.train_step(model, opt, tokens),
                3, tmp)
        _train_row("train_remat", cfg, n_params, losses, step_s, launches,
                   per_step, peak, remat_vs_plain=check, breakdown=breakdown,
                   train_max_memory_allocated=train["max_memory_allocated"],
                   train_step_ms=train["step_ms"])
    finally:
        basics.shutdown()
    return launches


def phase_train_accumulate(accumulate: int = 4) -> dict:
    """The 162M step with ``--accumulate 4`` at B = 8: the loss and
    gradients of ``accumulate_gradients`` against the full-batch step,
    within the train phase's bf16 bounds, and launches of 4× a step's."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.training import accumulate_gradients
    from horovod_tpu_torch.utils import trace

    basics.init()
    try:
        dev = basics.device()
        cfg = tt.train_config()
        model, opt = tt.make_trainer(cfg, dev, SEED, accumulate=accumulate)
        n_params = sum(p.numel() for p in model.parameters())
        tokens = tt.token_batch(cfg.vocab_size, dev)
        ref_loss, ref_grads = _one_step_grads(model, tokens)
        loss = accumulate_gradients(lambda mb: tt.loss_fn(model, mb),
                                    tokens, accumulate)
        check = _grads_vs(model, ref_loss, ref_grads, float(loss))
        del ref_grads
        model.zero_grad(set_to_none=True)
        _within_train_bounds("train_accumulate, 4 microbatches vs the full "
                             "batch", check)
        losses, step_s, launches, peak = _timed_steps(model, opt, tokens,
                                                      accumulate)
        per_step = _per_step(cfg, accumulate)
        _check_steps("train_accumulate", losses, launches, per_step)
        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "train_accumulate_step",
                lambda: tt.train_step(model, opt, tokens, accumulate), 3, tmp)
        _train_row("train_accumulate", cfg, n_params, losses, step_s,
                   launches, per_step, peak, accumulate=accumulate,
                   microbatch=tt.BATCH // accumulate,
                   accumulate_vs_full_batch=check, breakdown=breakdown)
    finally:
        basics.shutdown()
    return launches


def _is_bypass(plan) -> bool:
    """The adaptive planner's width-1 bypass: no hook, no collective."""
    return (plan is not None and plan["planner"] == "adaptive"
            and plan["width"] == 1 and not plan["chained"]
            and plan["reason"].startswith("width-1 bypass"))


def phase_resnet() -> None:
    """ResNet-50 on synthetic data (``train_resnet``) at full size on the
    card: the step of the ``BASELINE.json`` metric.  Its convolutions and
    batch norms are cuDNN's and PyTorch's; none of the port's kernels is on
    this path, and their counts over the run are reported (0 each)."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_resnet as tr
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.schedule_plan import overlap_plan
    from horovod_tpu_torch.utils import trace

    basics.init()   # NCCL, world 1
    try:
        torch.backends.cudnn.benchmark = True
        dev = basics.device()
        batch = 128
        t0 = time.monotonic()
        model, opt = tr.make_trainer(dev, SEED)
        x, y = tr.synthetic_batch(batch, dev)
        setup_s = time.monotonic() - t0
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses = [tr.train_step(model, opt, x, y)
                  for _ in range(RESNET_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.train_step(model, opt, x, y)
                   for _ in range(RESNET_STEPS)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / RESNET_STEPS
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        plan = overlap_plan()
        if not _is_bypass(plan) or plan["tensor_count"] != 161:
            raise AssertionError(f"resnet overlap plan at world 1: {plan}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"resnet losses not finite and falling: "
                                 f"{losses}")
        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "resnet_step", lambda: tr.train_step(model, opt, x, y), 3,
                tmp)
        img_s = batch / step_s
        emit("resnet", model="ResNet-50 v1.5 (1000 classes, bf16 compute / "
             "f32 params, channels-last)", params=n_params, batch=batch,
             image=[tr.IMAGE, tr.IMAGE, 3], processes=basics.size(),
             backend=torch.distributed.get_backend(),
             cudnn_benchmark=torch.backends.cudnn.benchmark, setup_s=setup_s,
             losses=losses, step_ms=step_s * 1e3, img_per_s=img_s,
             vs_baseline=img_s / tr.BASELINE_IMG_PER_SEC_PER_DEVICE,
             max_memory_allocated=peak, breakdown=breakdown,
             launches=launches, overlap_plan=plan)
    finally:
        basics.shutdown()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 1
    import horovod_tpu_torch  # noqa: F401  (fails here without the package)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()
    flash = phase_flash()
    dq, dkv = phase_flash_bwd()
    rms = phase_rmsnorm()
    rms_bwd = phase_rmsnorm_bwd()
    norm_rows = set()
    with record_norm_rows(norm_rows):
        serve_launches, serve_model = phase_serve()
        if not (serve_launches["flash_fwd"]
                and serve_launches["rmsnorm_fwd"]):
            raise AssertionError("the serve run launched no forward kernel")
        paged_launches = phase_serve_paged(serve_model)
        router_launches = phase_router(serve_model)
        del serve_model
        train = phase_train()
        phase_train_mixed(train)
        phase_train_remat(train)
        phase_train_accumulate()
    check_norm_rows(norm_rows)
    # Launches on the path: the serve, serve_paged (a-d), router and 162M
    # train runs, each counted from 0 around its own run.
    runs = {"serve": serve_launches, "serve_paged": paged_launches,
            "router": router_launches, "train": train["launches"]}
    launches = {k: sum(r[k] for r in runs.values()) for k in serve_launches}
    phase_resnet()
    entries = []
    tensor_cores, cuda_cores = "tensor cores (wgmma)", "CUDA cores"
    ring = "streamed through a two-stage TMA / mbarrier ring"
    for name, row, replaces, form, design in (
            ("flash_fwd", flash, "horovod_tpu/ops/flash_attention.py:70",
             tensor_cores, f"a block per 64- or 128-row q tile, K/V {ring}; "
             "S = q~.K^T and O += P.V by wgmma"),
            ("flash_bwd_dq", dq, "horovod_tpu/ops/flash_attention.py:389",
             tensor_cores, "a block per 64- or 128-row q tile, q~ and dO "
             f"resident, K/V {ring}; S = q~.K^T, dP = dO.V^T and "
             "dQ += dS.K by wgmma"),
            ("flash_bwd_dkv", dkv,
             "horovod_tpu/ops/flash_attention.py:487", tensor_cores,
             f"a block per 64-key tile, K/V resident, q and dO {ring}; "
             "S^T, dP^T, dV += P^T.dO and dK += dS^T.q~ by wgmma"),
            ("rmsnorm_fwd", rms, "horovod_tpu/ops/rmsnorm.py:62",
             cuda_cores, "a warp per row held in registers (16-byte "
             "vectors; rows of at most 2 KB, width a multiple of the "
             "vector, 16-byte aligned; else two passes over the row with "
             "scale prefetched to L1): every load of x and scale issued "
             "before the first add, one memory round trip a row, scale "
             "kept in registers across a warp's rows; a row's bits do not "
             "depend on N"),
            ("rmsnorm_bwd", rms_bwd, "horovod_tpu/ops/rmsnorm.py:69",
             cuda_cores, "one launch: a warp per row held in registers "
             "(16-byte vectors; rows of at most 2 KB, width a multiple of "
             "8; else a loop over the row), dscale summed across blocks "
             "in the same launch, in block order, by two levels of "
             "last-block tickets")):
        entries.append({
            "name": name, "route": "cuda", "form": form, "design": design,
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_by_run": {run: r[name] for run, r in runs.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "share_of_bound": row["bound_ms"] / row["kernel_ms"],
            "shape": row["shape"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(dev["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
