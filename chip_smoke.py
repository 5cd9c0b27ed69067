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
   tiles       — the flash tiles and shared memory that the context plan
                 reports (``kernel_tiles``, no card needed) equal to what
                 the built launchers say they launch, at every route;
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
   flash_offsets — the three flash kernels against their plain versions
                 at ``[1, S, 16, 128]`` bf16, S = 2048 and 4096, with the
                 offsets ring and zigzag attention launch them at,
                 ``(q_offset, k_offset)`` in (2048, 0), (4096, 2048) and
                 (0, 2048) (wholly masked at S = 2048: out 0, lse NEG_INF
                 and zero gradients, bit for bit), with times of each
                 kernel, its plain version and
                 ``F.scaled_dot_product_attention`` with the same boolean
                 mask (forward, or its backward), and each bound; then
                 the same at ``longctx_audit``'s calls in the examples
                 phase, ``[1, S, 2, 64]`` bf16, causal: the plain ring at
                 S = 256 a rank over two ranks, ``(q_offset, k_offset)``
                 in (0, 0), (256, 0) and (256, 256), and the zigzag
                 halves at S = 128, every pair of 0, 128, 256 and 384
                 (the examples phase fails if the audit made a call these
                 rows leave out);
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
   decode_attention — the decode attention kernel pair against its
                 plain version in f32 at the serving cell's shape
                 (``[32, S_q, 32, 128]`` over a ``[32, 4096, 32, 128]``
                 bf16 cache; S_q = 1 and 5) at live lengths (spread
                 evenly around the mix's 1,465 positions a slot) and at
                 the full cache, and at the 162M decoder's
                 ``[8, 1, 6, 128]`` over 2048 positions; kernel, plain
                 and ``F.scaled_dot_product_attention`` with the boolean
                 mask (a yardstick only) times, the bound (the live K and
                 V bytes over 3.35 TB/s) and its share, and a profiled
                 call that must show the two kernels of the pair;
7. serve       — the 162M decoder on the card with seeded weights, 16
                 requests through ``ServingEngine.submit`` /
                 ``run_until_idle``; launch counts of the forward kernels
                 over that run; one prefill repeated through the plain
                 versions;
   decode_graph — the dense backend's CUDA graphs of the cache step
                 against its eager path, on a fresh 162M (seed 0) at the
                 serving cell's 32 slots of 2048 positions: 64 requests
                 (100-1000 prompt tokens, 8-96 new, so slots refill and
                 every slot's length moves) through two engines, one
                 over a graphed backend, one over an eager backend of the
                 same model; then 4 verify blocks of 32 x 5 (spec k = 4)
                 at ragged lengths, and a decode either side of a
                 ``swap_params`` to seed-4 weights.  Checks: at least 64
                 decodes; every token and every row of logits equal bit
                 for bit; both caches equal bit for bit after each part;
                 one capture a shape, every later cache step a replay;
                 each kernel's launches equal the eager path's, call by
                 call; the replay after the swap equal to the eager step
                 with the new weights and not the old.  Prints the host
                 ms of a decode either way and each run's tokens/s;
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
   serve_fleet — fleet serving on the card: 2 founding replicas of
                 ``python -m horovod_tpu_torch.serving`` (162M, seed 0,
                 ``HVD_TPU_ELASTIC=1``, the soak's heartbeat settings),
                 each ticking the ``serving.tick`` collective over the
                 port's native engine while it serves a Poisson stream of
                 4 requests/s for 6 s, and a joiner (seed 1) started 2 s
                 later with ``HVD_TPU_ELASTIC_JOIN=1``, which pulls its
                 ring neighbour's weights over the bulk data plane.
                 Checks: every request of every replica completes; the
                 joiner's tensor CRCs equal what the donor shipped; no
                 disk read, the ``direct`` transport; a probe prompt
                 served alone gives the same 16 greedy tokens on the
                 joiner as on the donor; every replica launched the
                 flash and RMSNorm forward kernels.  Prints each
                 replica's tick host ms, TTFT and token gaps (beside
                 ``serve``'s), tokens/s and peak memory, the clone's
                 bytes and ms, and the joiner's wait for admission and
                 time from admission to its first token;
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
   train_eager — the same 162M step through the eager engine path:
                 ``init`` on NCCL at world 1 with ``HVD_TPU_EXECUTOR=
                 multihost`` (the device route), the binding's
                 ``horovod_tpu_torch.torch.DistributedOptimizer(AdamW)``
                 with parameters and optimizer state broadcast through the
                 engine; 3 warm-up and 10 timed steps.  Checks: the five
                 kernels' launches a step, a falling finite loss, a
                 response-cache hit for every gradient tensor from the
                 second step on, and, in a step whose backward is queued
                 behind a spin kernel, every gradient after ``synchronize``
                 bitwise equal to the copy its hook took.  Prints the
                 engine's batches and their bytes a step, step time
                 against ``train``'s, tokens/s, the executor's host ms, its
                 stream span and device ms a step, the idle share and peak
                 memory;
   train_eager_2proc — two processes on the card (``chip_smoke.py
                 --eager-worker``), the gather route over gloo, the 162M
                 widths at depth 2, B = 2 a rank: 3 steps on
                 ``Compression.none`` and 3 on ``Compression.int8``.
                 Checks, every step: both ranks' parameters bitwise equal;
                 the reduced gradients against a host f32 sum of both
                 ranks' (rel. L2 <= 1e-6), or on int8 within the sum of
                 the ranks' scales; each rank's launches;
   train_resume — the 162M step at full width and depth (B = 8, f32
                 parameters, ``DistributedOptimizer(AdamW)``, NCCL, world
                 1) as the step function of ``training.elastic_loop``,
                 each a job of ``python -m horovod_tpu_torch.run -np 1``
                 (``chip_smoke.py --resume-worker``): token batches seeded
                 by the step index through ``data.BackgroundLoader`` and
                 ``data.prefetch_to_device``, ``CheckpointManager(dir,
                 max_to_keep=2)`` under ``HVD_TPU_CKPT_ASYNC=1`` every 2
                 steps, the data position in the metadata.  (a) 8 steps
                 twice (the second without checkpoints): whether the step
                 is bitwise deterministic on the card; (b) the same under
                 ``--max-restarts 1 --ckpt-dir`` with rank 0 killed at
                 step 5: the launcher relaunches from step 3's checkpoint
                 and attempt 1 runs steps 4-7.  Checks: the restored state
                 bitwise the state CRC'd at step 3's save; (b)'s losses and
                 final CRCs equal (a)'s (bitwise when deterministic, else
                 |dloss| <= 1e-4 and parameter rel. L2 <= 1e-3); launches
                 12/12/12/25/25 a step in every process; a falling finite
                 loss.  Prints the checkpoint's bytes, each save's stall and
                 persist ms, the restore ms, the kill to attempt 1's first
                 step, step ms before and after, and 3 traced steps;
   train_elastic_3proc — three engine-only processes on the card
                 (``--elastic-worker``), each its own ``NativeEngine`` with
                 the local executor, the 162M widths at depth 2, B = 2, the
                 same batch on every rank, ``elastic_loop`` with a
                 checkpoint every step under ``HVD_TPU_ELASTIC=1``,
                 ``HVD_TPU_CKPT_REPLICATE=1`` and ``HVD_TPU_CKPT_ASYNC=1``;
                 rank 2 killed at step 3 of 4.  Checks: the survivors keep
                 their pids, shrink to size 2, restore step 2 from the peer
                 replica with 0 disk reads and bitwise the state they
                 CRC'd at its save, end bitwise equal to each other and
                 (when the step is deterministic) to an uninterrupted
                 3-rank run; their launches.  Prints the recovery ms (the
                 victim's last save to the survivors' first step after the
                 shrink), the replica bytes shipped and the restore ms;
   longctx     — ``python -m horovod_tpu_torch.train_longseq`` at full
                 width and depth (8 x 2048, 16 heads of 128, GLU 8192,
                 vocab 32000, bf16 over f32 parameters, the RMSNorm
                 kernels), one process (width 1, the plain layout), S =
                 8192 and 32768: one step through the kernels against the
                 same step through the plain versions (the train bounds),
                 then 3 warm-up and 5 timed steps: exact launches (8 of
                 each flash kernel and 17 of each RMSNorm kernel a step, the
                 forward ones doubled under remat), a falling finite loss,
                 tokens/s, MFU, peak memory, one traced step and the plan;
   longctx_2proc — two processes on the card under ``python -m
                 horovod_tpu_torch.run -np 2`` (``--longctx-worker``),
                 gloo, width 2, S = 8192, the planned zigzag layout: one
                 step's mean loss and averaged gradients against the
                 width-1 run on the same weights and tokens (the train
                 bounds), the plain layout pinned (``layout="plain"``) with
                 ``steps_run == rank + 1`` and Ulysses, both against one
                 flash call on the whole sequence, 3 steps with 4n = 8 of
                 each flash kernel a layer, the exchange's bytes and host
                 ms;
   parallel_2proc — two processes on the card under the launcher
                 (``--parallel-worker``), gloo, the 162M decoder at full
                 width, B = 8, S = 1024, 1 warm-up and 3 timed steps a
                 leg: the GPipe pipeline (2 stages of 6 blocks, 4
                 microbatches) against the sequential model (the train
                 bounds), MoE over both ranks (falling loss, tokens
                 dropped, distinct experts), ZeRO-1 (parameters bitwise
                 equal across ranks, half the optimizer state) and FSDP
                 (half the parameter, gradient and state bytes), both
                 against the replicated step's losses, and the
                 tensor-parallel MLP against the dense one; exact
                 launches a leg, the RMSNorm rows it launched checked by
                 ``rmsnorm_rows``;
9. resnet      — the ResNet-50 step of ``python -m
                 horovod_tpu_torch.train_resnet`` at full size (128 images
                 of 224×224×3 on the card, bf16 over f32 parameters,
                 ``DistributedOptimizer(SGD(0.01, momentum=0.9))``): 3
                 warm-up and 8 timed steps, img/s, step time, device busy
                 time and idle share, device time by kind, peak memory, a
                 finite loss falling on the fixed batch, and
                 ``overlap_plan()``, which must be the adaptive planner's
                 width-1 bypass;
   cnn         — the reference's benchmark table through
                 ``train_synthetic``'s step at full width and depth, 32
                 images a card, NCCL world 1, 3 warm-up and 8 timed steps
                 each: VGG-16 at 224² (dropout 0) and Inception V3 at 299²
                 with its aux head (loss = head + 0.4·aux).  Parameters,
                 img/s, step ms, peak memory, the breakdown with BatchNorm's
                 and the convolutions' shares of the device time, a finite
                 loss falling on the fixed batch, the width-1 bypass, and
                 the port kernels' launches (0 each);
   sync_bn_2proc — two processes on the card under the launcher
                 (``--sync-bn-worker``), gloo: ResNet-50 with cross-replica
                 BatchNorm, 16 images a rank of one seeded batch, 3 steps,
                 and the same with local BatchNorm.  Checks: the running
                 statistics bitwise equal across the ranks after every
                 step when synced, unequal when local; step 1's mean loss
                 and averaged gradients against one process on the 32
                 images with local BatchNorm (|Δloss| ≤ 0.02, gradient
                 rel. L2 over all parameters ≤ 0.05);
   profile     — ``horovod_tpu_torch.profiling.trace`` around two 162M
                 training steps, each in ``annotate("train_step")``: the
                 Chrome trace holds both spans and kernels of all five
                 port kernels, exact launches; its size;
   control_plane — ``star_bench`` and ``fleet_sim`` built from
                 ``horovod_tpu_torch/core/src/tools`` (both at once) and
                 run: ``fleet_sim --p 64 --fanout 8 --ticks 12`` and
                 ``star_bench`` at P = 8 (host programs);
   analysis    — the analysis tools on the card's host, each timed: every
                 golden frame of the port's wire mirror
                 (``analysis/protocol/wire.py``, 17 frame types) and the
                 bulk token against the port's native encoder as built
                 here; the port's linter over ``horovod_tpu_torch``,
                 ``tests/test_torch_*.py`` and this script (0 findings);
                 ``python -m horovod_tpu_torch.analysis.protocol`` at its
                 default depth ("all invariants hold");
   examples    — the repo's example entry points
                 (``horovod_tpu_torch.examples``) on the card, each a child
                 under ``python -m horovod_tpu_torch.run``, full width and
                 cut step counts, all 13: ``mnist`` (1 epoch),
                 ``mnist_advanced`` (its 4 epochs of 8 steps: warmup,
                 decay), ``imagenet_resnet50``
                 (224², 32 images, 2 steps an epoch: 1 epoch, then 2 that
                 resume from epoch 0), ``word2vec`` (20 steps),
                 ``torch_mnist`` (1 epoch), ``torch_synthetic_benchmark``
                 (convnet), ``collective_microbench`` (1, 16, 256 MB and
                 the dispatch floor), ``control_plane_benchmark`` (world 1,
                 then ``--star 8,64``), ``weak_scaling_benchmark`` (16 MB),
                 ``resnet_bn_experiment`` (64 images, both legs with their
                 breakdowns), ``int8_convergence`` (width 64 on the port's
                 wire, 40 steps: each int8 run within 0.01 of the f32
                 losses), ``overlap_audit`` (world 1: the bypass) and
                 ``longctx_audit`` (two processes on the card over gloo,
                 ``--assert-planner``: the three flash kernels at the
                 ring's offsets, each call one that ``flash_offsets``
                 checked).  Each child's return code and lines are
                 checked; the children checked only for correctness run
                 five at a time, then the ones whose numbers PERF.md
                 reads run alone; the phase's seconds, each child's, and
                 their rows;
10. kernels    — ``{"kernels": [...]}``, one entry per kernel of the path,
                 with the form it runs in for bf16 inputs (the three flash
                 kernels on the tensor cores, the two RMSNorm kernels on
                 the CUDA cores) and a line on its design; ``launches`` is
                 the sum over the serve, serve_paged (a-d), router,
                 serve_fleet (summed over its replicas' reports), train,
                 train_eager, train_resume (summed over its processes),
                 longctx, longctx_2proc, parallel_2proc (summed over
                 its ranks and legs), cnn and sync_bn_2proc (0 each),
                 profile and examples (``longctx_audit``'s ranks) runs,
                 each counted from 0 around its own run
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
import os
import shutil
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
# decode_graph: the serving cell's 32 slots, 64 requests of 100-1000
# prompt tokens and 8-96 new ones, verify blocks of spec k = 4, and host
# ms of a decode over 32 calls.
GRAPH_SLOTS, GRAPH_REQUESTS, GRAPH_NEW = 32, 64, (8, 96)
GRAPH_SPEC_K, GRAPH_VERIFY_BLOCKS, GRAPH_TIMED = 4, 4, 32
# serve_fleet: 2 founding replicas and a joiner started 2 s after them,
# each serving a Poisson stream of 4 requests/s for 6 s (prompts of 126,
# 254 and 510 tokens); the probe is 16 greedy tokens; every replica must
# report within 120 s.
FLEET_FOUNDERS, FLEET_QPS, FLEET_DURATION_S = 2, 4.0, 6.0
FLEET_JOIN_AFTER_S, FLEET_PROBE_TOKENS, FLEET_TIMEOUT_S = 2.0, 16, 120.0
# flash_offsets: the three flash kernels at [1, S, H, D] bf16, (S,
# q_offset, k_offset, H, D): at the long-context model's 16 heads of 128,
# with both offsets
# set, as ring and zigzag attention launch them (queries past their keys,
# both past the diagonal, and keys after every query: at S = 2048 wholly
# masked, out 0, lse NEG_INF, zero gradients; S = 2048 is a zigzag
# half-pair at S = 8192 over two ranks), and the width-1 calls at S =
# 8192 and 32768.
# The examples phase's longctx_audit: two ranks of S = 256 tokens, 2
# heads of 64; its plain ring calls the kernels at S = 256 (rank r's
# queries at r·S against each earlier shard), its zigzag ring at the
# halves, S = 128, every pair of the four chunks' offsets.
LONGCTX_AUDIT_RANKS, LONGCTX_AUDIT_SEQ = 2, 256
LONGCTX_AUDIT_HEADS, LONGCTX_AUDIT_HEAD_DIM = 2, 64


def _audit_offset_rows() -> tuple:
    n, s, c = LONGCTX_AUDIT_RANKS, LONGCTX_AUDIT_SEQ, LONGCTX_AUDIT_SEQ // 2
    chunks = sorted({o for r in range(n)
                     for o in (r * c, (2 * n - 1 - r) * c)})
    hd = (LONGCTX_AUDIT_HEADS, LONGCTX_AUDIT_HEAD_DIM)
    return tuple((s, my * s, owner * s) + hd for my in range(n)
                 for owner in range(my + 1)) + tuple(
        (c, q, k) + hd for q in chunks for k in chunks)


FLASH_OFFSET_ROWS = tuple((s, q, k, 16, 128) for s in (2048, 4096)
                          for q, k in ((2048, 0), (4096, 2048), (0, 2048))
                          ) + ((8192, 0, 0, 16, 128), (32768, 0, 0, 16, 128)
                               ) + _audit_offset_rows()
# longctx: train_longseq at full width and depth (8 x 2048, 16 heads of
# 128, GLU 8192, vocab 32000), width 1, 3 warm-up and 5 timed steps at
# each length; longctx_2proc: two processes on the card under the
# launcher, gloo exchange, width 2 at S = 8192.
LONGCTX_SEQS = (8192, 32768)
LONGCTX_2PROC_SEQ = 8192
LONGCTX_2PROC_STEPS = 3
LONGCTX_TIMEOUT_S = 400.0
# parallel_2proc: two processes on the card under the launcher (gloo), the
# 162M decoder at full width and B = 8, S = 1024 (4 rows a rank but under
# the pipeline, which runs all 8 as 4 microbatches of 2), 1 warm-up and 3
# timed steps a leg; the tensor-parallel leg's ParallelMLP 768 -> 3072 ->
# 768 over [8192, 768] bf16.
PARALLEL_WARMUP, PARALLEL_STEPS, PARALLEL_MICROBATCHES = 1, 3, 4
PARALLEL_TP_ROWS = 8192
PARALLEL_TIMEOUT_S = 600.0
# (B, S_q, S_k, causal, q_offset): [B, S, 6, 128] bf16.  The serving
# prefill buckets, S=1000 (masked edge tiles), a longer and a non-causal
# row, a query block past its keys, the training step's shape, one
# microbatch of it under `--accumulate 4` (B = 2, also a GPipe microbatch
# of parallel_2proc), and a rank's half of it at width 2 (B = 4: the MoE,
# ZeRO and FSDP legs of parallel_2proc).
FLASH_SHAPES = (
    (1, 128, 128, True, 0), (1, 256, 256, True, 0), (1, 512, 512, True, 0),
    (1, 1000, 1000, True, 0), (1, 1024, 1024, True, 0),
    (1, 2048, 2048, True, 0), (1, 1024, 1024, False, 0),
    (1, 128, 1024, True, 896), (8, 1024, 1024, True, 0),
    (2, 1024, 1024, True, 0), (4, 1024, 1024, True, 0))
FLASH_BWD_SHAPES = (
    (8, 1024, 1024, True, 0), (2, 1024, 1024, True, 0),
    (4, 1024, 1024, True, 0),
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
# (8 decode slots; the paged verify block of 8 slots x 5; decode_graph's
# 32 slots and its verify block of 32 x 5; the prefill buckets 128-1024;
# a microbatch of 2 x 1024; a rank's 4 x 1024 of the 162M step at width
# 2; a training step's 8192), and 1 and 1000.  ``main`` fails when a main
# path gives it another (``record_norm_rows``).
RMS_ROWS = (1, 8, 32, 40, 128, 160, 256, 512, 1000, 1024, 2048, 4096,
            8192)
# [N, 2048] bf16: the long-context step's rows, a rank's shard of S =
# 8192 at width 2, and S = 8192 and 32768 at width 1 (rows of 4 KB: the
# loop form).
LONGCTX_RMS_ROWS = (4096, 8192, 32768)
# (dtype, N, E) of the RMSNorm forward's checks: the bf16 rows of every
# path (the register form at 768, the loop form at 2048) and the f32
# training step's rows (3 KB: the loop form).
RMS_CASES = tuple((torch.bfloat16, n, 768) for n in RMS_ROWS) + (
    (torch.float32, 8192, 768),) + tuple(
    (torch.bfloat16, n, 2048) for n in LONGCTX_RMS_ROWS)
# (N, E) of the RMSNorm backward's checks: the 162M step's width (a
# microbatch, a rank's half at width 2, the whole step), the long-context
# step's, and widths past 7168 (the wide form, a block a row).
RMS_BWD_CASES = ((1000, 768), (2048, 768), (4096, 768), (8192, 768),
                 (1024, 8192), (1024, 12288)) + tuple(
    (n, 2048) for n in LONGCTX_RMS_ROWS)
# The register form's longest row (csrc/rmsnorm_fwd.cu kRegRowBytes).
RMS_REG_ROW_BYTES = 2048
RMS_MAIN = 8192                         # one training step's tokens
# Decode attention rows: (B, S_q, S, H, lengths); "live" spreads the
# slots evenly from 1/4 to 7/4 of the serving mix's time-weighted mean of
# 1,465 live positions a slot, "full" reads every position.
DECODE_LIVE_MEAN = 1465
DECODE_ROWS = ((32, 1, 4096, 32, "live"), (32, 1, 4096, 32, "full"),
               (32, 5, 4096, 32, "live"), (8, 1, 2048, 6, "live"))
DECODE_MAIN = DECODE_ROWS[0]
DECODE_ATOL = 1e-4
RESNET_WARMUP, RESNET_STEPS = 3, 8
# cnn: VGG-16 (224²) and Inception V3 (299², the aux head, loss head +
# 0.4·aux) at full width and depth through train_synthetic's step, batch
# 32 a card, 3 warm-up and 8 timed steps each.  sync_bn_2proc: ResNet-50
# with cross-replica BatchNorm, two processes on the card over gloo, 16
# images a rank, 3 steps a leg.  profile: the 162M step traced twice.
# control_plane: the JAX core Makefile's fleet-soak settings and a star
# benchmark at P = 8.
CNN_BATCH, CNN_WARMUP, CNN_STEPS = 32, 3, 8
CNN_MODELS = (("VGG16", {}), ("InceptionV3", {"aux_logits": True}))
SYNC_BN_BATCH, SYNC_BN_STEPS, SYNC_BN_TIMEOUT_S = 16, 3, 300.0
PROFILE_STEPS = 2
FLEET_SIM = {"p": 64, "ticks": 12, "fanout": 8}
STAR_BENCH_P, STAR_BENCH_TICKS = 8, 200
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

    if sorted(_build.KERNELS) != ["decode_attention", "flash_bwd_dkv",
                                  "flash_bwd_dq", "flash_fwd",
                                  "rmsnorm_bwd", "rmsnorm_fwd"]:
        raise AssertionError(f"kernels registered: {sorted(_build.KERNELS)}")
    def load(k):
        t = time.monotonic()
        k.load()
        return time.monotonic() - t

    # One thread per kernel, so every nvcc runs at once; the native tools
    # of the control_plane phase build beside them (g++, host programs).
    from horovod_tpu_torch.core import _build as core_build

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(_build.KERNELS)
                            + len(core_build.TOOLS)) as pool:
        tools = [pool.submit(core_build.build_tool, name)
                 for name in core_build.TOOLS]
        per = dict(zip(_build.KERNELS,
                       pool.map(load, _build.KERNELS.values())))
        for f in tools:
            f.result()
    ptxas = {name: [ln.strip() for ln in k.build_log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
             for name, k in _build.KERNELS.items()}
    emit("build", seconds=time.monotonic() - t0, per_kernel_s=per,
         ptxas=ptxas)


def phase_tiles() -> None:
    """``ops.flash_attention.kernel_tiles``, which the context plan reports
    and which needs no card, against what the built launchers say they
    launch (``launcher_tiles``) at every route: both dtypes, head dims 64
    to 320, few and many q rows, and batch·heads on both sides of the
    card's SM count."""
    from horovod_tpu_torch.ops import flash_attention as fa

    checked = 0
    for dtype_bytes in (2, 4):
        for d in (64, 96, 128, 256, 320):
            for s_q, bh in ((64, 1), (2048, 16), (4096, 16), (32768, 16),
                            (1024, 48), (1024, 8)):
                want = fa.launcher_tiles(d, dtype_bytes, s_q, bh)
                got = fa.kernel_tiles(d, dtype_bytes, s_q, bh)
                if got != want:
                    raise AssertionError(
                        f"kernel_tiles({d}, {dtype_bytes}, {s_q}, {bh}) = "
                        f"{got}, the launchers launch {want}")
                checked += 1
    emit("tiles", shapes_checked=checked,
         sms=torch.cuda.get_device_properties(0).multi_processor_count,
         longctx=fa.launcher_tiles(128, 2, 8192, 16))


def _visible(s_q, s_k, causal, q_off, k_off=0):
    qpos = q_off + torch.arange(s_q, device="cuda")
    kpos = k_off + torch.arange(s_k, device="cuda")
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
    scales = {e: 1.0 + 0.1 * torch.randn(e, generator=gen, device="cuda")
              for e in sorted({e for _, _, e in RMS_CASES})}
    worst, main = 0.0, None
    lib_fn = getattr(F, "rms_norm", None)
    # The least a call can take: one empty launch, timed the same way.
    launch_floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    for dtype, n, e in RMS_CASES:
        scale = scales[e]
        x = torch.randn(n, e, generator=gen, device="cuda", dtype=dtype)
        y = rn.rms_norm(x, scale)
        ref = rn.rms_norm_reference(x, scale)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        tag = f"rmsnorm {str(dtype)[6:]} N={n} E={e}"
        err = check_close(tag, y, ref, RMS_ATOL,
                          BF16_RTOL if bf16 else RMS_F32_RTOL)
        if bf16:
            worst = max(worst, err)
        # One call, one kernel, of the form the shape picks: rows of at
        # most 2 KB (bf16 at 768) in registers, longer ones (f32 at 768,
        # bf16 at 2048) in the loop.
        form = "rmsnorm_fwd_regs_kernel" if e * x.element_size() <= \
            RMS_REG_ROW_BYTES else "rmsnorm_fwd_kernel"
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
        if bf16 and (n, e) == (RMS_MAIN, 768):
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


def _decode_lengths(b: int, s: int, kind: str, mean: int) -> torch.Tensor:
    if kind == "full":
        return torch.full((b,), s - 1, device="cuda")
    return torch.tensor([min(s - 1, round(mean * (0.25 + 1.5 * i / (b - 1))))
                         for i in range(b)], device="cuda")


def phase_decode_attention() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import decode_attention as da
    from horovod_tpu_torch.utils import trace

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst, main = 0.0, None
    for row_key in DECODE_ROWS:
        b, s_q, s, h, kind = row_key
        d = 128
        q = torch.randn(b, s_q, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        lengths = _decode_lengths(b, s, kind,
                                  DECODE_LIVE_MEAN * s // 4096)
        out = da.decode_attention(q, k, v, lengths)
        want = da.decode_attention_reference(q.float(), k.float(), v.float(),
                                             lengths)
        torch.cuda.synchronize()
        tag = f"decode_attention B={b} S_q={s_q} S={s} H={h} {kind}"
        # One rounding of an f32 result to bf16 (see the card tests).
        err = check_close(tag, out, want, DECODE_ATOL, 2.0 ** -8)
        del want
        worst = max(worst, err)
        names = trace.kernels_in_one_call(
            lambda: da.decode_attention(q, k, v, lengths))
        if len(names) != 2 or not all("decode_attention" in n
                                      for n in names):
            raise AssertionError(f"{tag}: one call ran {names}")
        visible = int((torch.clamp(lengths + s_q, max=s)).sum())
        # Live K and V read once, q in and the output out (bf16).
        nbytes = 2.0 * (2 * visible * h * d + 2 * b * s_q * h * d)
        flops = 4.0 * visible * s_q * h * d
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_CUDA_CORE_FLOPS)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        qpos = lengths[:, None] + torch.arange(s_q, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        row = dict(
            shape=[b, s_q, h, d], s=s, lengths=kind,
            mean_visible=visible / b, max_abs_err=err,
            kernel_ms=time_ms(lambda: da.decode_attention(q, k, v,
                                                          lengths)),
            plain_ms=time_ms(lambda: da.decode_attention_reference(
                q, k, v, lengths), iters=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), iters=5),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops,
            bytes=nbytes, kernels_per_call=names)
        row["share_of_bound"] = bound_ms / row["kernel_ms"]
        del qt, kt, vt, q, k, v
        emit("decode_attention", **row)
        if row_key == DECODE_MAIN:
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
    read0, dense0 = backend.kv_positions_read, backend.kv_positions_dense
    t0 = eng.clock()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = eng.clock() - t0
    launches = _launches()
    prefills, steps = eng.counters["admitted"], eng.counters["steps"]
    cache_steps = (backend.kv_positions_dense - dense0) // (
        scfg.num_slots * scfg.max_seq_len)
    kv_read_share = (backend.kv_positions_read - read0) / (
        backend.kv_positions_dense - dense0)
    if launches["decode_attention"] != cache_steps * mcfg.num_layers:
        raise AssertionError(
            f"decode attention launches {launches['decode_attention']} != "
            f"decode steps {cache_steps} x {mcfg.num_layers}")

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
         kv_read_share=kv_read_share,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         plain_max_abs_dlogits=dlogits, plain_argmax_match=argmax_ok)
    return launches, model, rep


def _same_launches(tag, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{tag}: launches {got} with the graph, "
                             f"{want} eager")


def _launch_delta(fn):
    """``fn()``'s result and each kernel's launches during it."""
    before = _launches()
    out = fn()
    return out, {k: n - before[k] for k, n in _launches().items()}


def _bitwise(tag, got, want) -> None:
    for g, w in zip(got, want, strict=True):
        if not np.array_equal(g, w):
            raise AssertionError(f"{tag}: the replay differs from the "
                                 f"eager step by {np.abs(g - w).max()}")


def _caches_equal(tag, a, b) -> None:
    if not (torch.equal(a.kk, b.kk) and torch.equal(a.vv, b.vv)):
        raise AssertionError(f"{tag}: the graphed backend's cache differs "
                             "from the eager one's")


def _decode_host_ms(backend, tokens, lengths) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED):
        backend.decode(tokens, lengths)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED


def phase_decode_graph() -> dict:
    """``TransformerBackend``'s CUDA graphs against its eager cached
    forward, as the module's docstring says."""
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      config_162m)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.serving.engine import (ServingEngine,
                                                  TransformerBackend)

    t_phase = time.monotonic()
    cfg = dataclasses.replace(_serve_config(), num_slots=GRAPH_SLOTS)
    mcfg = config_162m(max_seq_len=cfg.max_seq_len)
    model = Transformer(mcfg, device="cuda")
    model.load_state_dict(init_params(mcfg, SEED))
    graphed = TransformerBackend(model, cfg.num_slots, cfg.max_seq_len)
    eager = TransformerBackend(model, cfg.num_slots, cfg.max_seq_len)
    if graphed.graphs != {}:
        raise AssertionError("the dense backend keeps no graphs on the card")
    eager.graphs = None                    # the eager cached forward
    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(100, 1001, GRAPH_REQUESTS)
    news = rng.integers(GRAPH_NEW[0], GRAPH_NEW[1] + 1, GRAPH_REQUESTS)
    prompts = [list(map(int, rng.integers(1, mcfg.vocab_size, n)))
               for n in lens]

    # (a) The engine over each backend: refills, moving lengths.
    runs = {}
    for name, backend in (("eager", eager), ("graph", graphed)):
        eng = ServingEngine(backend, cfg)
        torch.cuda.synchronize()
        _build.reset_launches()
        steps0 = backend.cache_steps
        t0 = time.monotonic()
        reqs = [eng.submit(p, int(n)) for p, n in zip(prompts, news)]
        eng.run_until_idle()
        torch.cuda.synchronize()
        runs[name] = dict(reqs=reqs, launches=_launches(),
                          wall=time.monotonic() - t0,
                          decodes=backend.cache_steps - steps0,
                          admitted=eng.counters["admitted"])
    a, b = runs["graph"], runs["eager"]
    if a["decodes"] != b["decodes"] or a["decodes"] < 64:
        raise AssertionError(f"decode_graph: {a['decodes']} decodes with "
                             f"the graph, {b['decodes']} eager (>= 64)")
    if a["launches"]["decode_attention"] != a["decodes"] * mcfg.num_layers:
        raise AssertionError(f"decode_graph: decode attention launches "
                             f"{a['launches']['decode_attention']} != "
                             f"{a['decodes']} x {mcfg.num_layers}")
    _same_launches("decode_graph (engine)", a["launches"], b["launches"])
    rows = 0
    for g, w in zip(a["reqs"], b["reqs"], strict=True):
        if g.tokens != w.tokens or len(g.tokens) != g.max_new_tokens:
            raise AssertionError(f"decode_graph: request {g.rid}'s tokens "
                                 "differ from the eager run's")
        _bitwise(f"decode_graph: request {g.rid}", g.logits, w.logits)
        rows += len(g.logits)
    _caches_equal("decode_graph (engine)", graphed, eager)
    st = graphed.kv_read_stats()
    if (st["decode_graph_captures"], st["decode_graph_replays"]) != \
            (1, a["decodes"] - 1):
        raise AssertionError(f"decode_graph: {st} after {a['decodes']} "
                             "decodes (1 capture, a replay after the first)")

    # (b) Verify blocks of spec k = 4: eager, capture, then replays.
    s_q = GRAPH_SPEC_K + 1
    lengths = rng.integers(1, cfg.max_seq_len - GRAPH_VERIFY_BLOCKS * s_q,
                           cfg.num_slots)
    for i in range(GRAPH_VERIFY_BLOCKS):
        block = rng.integers(1, mcfg.vocab_size, (cfg.num_slots, s_q))
        got, n_got = _launch_delta(lambda: graphed.verify(block, lengths))
        want, n_want = _launch_delta(lambda: eager.verify(block, lengths))
        _same_launches(f"decode_graph (verify {i})", n_got, n_want)
        _bitwise(f"decode_graph (verify {i})", got, want)
        lengths = lengths + s_q
    _caches_equal("decode_graph (verify)", graphed, eager)

    # (c) swap_params under a captured graph.
    tokens = rng.integers(1, mcfg.vocab_size, cfg.num_slots)
    old = graphed.decode(tokens, lengths)
    _bitwise("decode_graph (before the swap)", old,
             eager.decode(tokens, lengths))
    graphed.swap_params(init_params(mcfg, SEED + 4))  # one model: both
    got, n_got = _launch_delta(lambda: graphed.decode(tokens, lengths))
    want, n_want = _launch_delta(lambda: eager.decode(tokens, lengths))
    _same_launches("decode_graph (swap)", n_got, n_want)
    _bitwise("decode_graph (swap)", got, want)
    if np.array_equal(got[1], old[1]):
        raise AssertionError("decode_graph: the replay after swap_params "
                             "gave the old weights' logits")
    _caches_equal("decode_graph (swap)", graphed, eager)
    st = graphed.kv_read_stats()
    if st["decode_graph_captures"] != 2:
        raise AssertionError(f"decode_graph: {st['decode_graph_captures']} "
                             "captures (one decode, one verify width)")
    decode_ms = {name: _decode_host_ms(backend, tokens, lengths)
                 for name, backend in (("eager", eager), ("graph", graphed),
                                       ("eager_again", eager),
                                       ("graph_again", graphed))}
    tokens_out = sum(len(r.tokens) for r in a["reqs"])
    emit("decode_graph", model="162M decoder, seed 0 (seed 4 after the "
         "swap)", slots=cfg.num_slots, max_seq_len=cfg.max_seq_len,
         requests=GRAPH_REQUESTS, refills=a["admitted"] - cfg.num_slots,
         decodes=a["decodes"], logit_rows_bitwise=rows,
         verify_blocks=GRAPH_VERIFY_BLOCKS, verify_s_q=s_q,
         launches=a["launches"], launches_equal_eager=True,
         swap_params_bitwise=True, graph_stats=st,
         decode_host_ms=decode_ms,
         tokens_per_s={k: tokens_out / r["wall"] for k, r in runs.items()},
         seconds=time.monotonic() - t_phase)
    del graphed, eager, model
    torch.cuda.empty_cache()
    return a["launches"]


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


def _fleet_replica(args, env, **extra):
    from horovod_tpu_torch.serving.soak import Replica

    return Replica([sys.executable, "-m", "horovod_tpu_torch.serving",
                    "--probe", str(FLEET_PROBE_TOKENS), *args],
                   {**env, **extra})


def _serve_report(rep, timeout_s: float, fleet) -> dict:
    line = rep.wait_line("SERVE_REPORT ", timeout_s)
    if line is None or rep.proc.wait(timeout=timeout_s) != 0:
        for r in fleet:
            if r.proc.poll() is None:
                r.proc.kill()
        raise AssertionError("a fleet replica failed:\n" + "\n".join(
            f"--- replica {i}, exit {r.proc.wait()}:\n"
            + "\n".join(r.lines[-40:]) for i, r in enumerate(fleet)))
    return json.loads(line.split(" ", 1)[1])


def phase_serve_fleet(serve_rep: dict) -> dict:
    """Fleet serving of the 162M decoder on the card: ``FLEET_FOUNDERS``
    replicas of ``python -m horovod_tpu_torch.serving`` (seed ``SEED``),
    each ticking the ``serving.tick`` collective over the port's native
    engine, then a joiner (seed ``SEED + 1``) admitted mid-traffic, which
    pulls its ring neighbour's weights over the bulk data plane.  Returns
    the launches summed over every replica's serving run."""
    from horovod_tpu_torch.serving.soak import FLEET_ENV, free_port

    t_phase = time.monotonic()
    env = {**os.environ, **FLEET_ENV, "PYTHONFAULTHANDLER": "1",
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
           "HVD_TPU_COORDINATOR_PORT": str(free_port()),
           "HVD_TPU_SERVE_SLOTS": "8",
           "HVD_TPU_SERVE_BUCKETS": "128,256,512,1024",
           "HVD_TPU_SERVE_MAX_LEN": "2048",
           "HVD_TPU_SERVE_QPS": str(FLEET_QPS),
           "HVD_TPU_SERVE_DURATION_S": str(FLEET_DURATION_S)}
    n = FLEET_FOUNDERS
    fleet = [_fleet_replica(["--seed", str(SEED)], env,
                            JAX_PROCESS_ID=str(r), JAX_NUM_PROCESSES=str(n))
             for r in range(n)]
    try:
        # The joiner builds its model while the founders build theirs and
        # start serving, then knocks: it is admitted mid-traffic.
        time.sleep(FLEET_JOIN_AFTER_S)
        fleet.append(_fleet_replica(
            ["--seed", str(SEED + 1)], env, JAX_PROCESS_ID=str(n),
            JAX_NUM_PROCESSES=str(n + 1), HVD_TPU_ELASTIC_JOIN="1"))
        reps = [_serve_report(r, FLEET_TIMEOUT_S, fleet) for r in fleet]
    finally:
        for r in fleet:
            if r.proc.poll() is None:
                r.proc.kill()
    joiner = reps[-1]
    donors = [r for r in reps if "shipped" in r]
    if len(donors) != 1 or "pulled" not in joiner:
        raise AssertionError("serve_fleet: no weight clone took place "
                             f"({len(donors)} donors)")
    donor, pulled = donors[0], joiner["pulled"]
    shipped = donor["shipped"]
    for r in reps:
        if r["completed"] != r["offered"] or r["timed_out"] \
                or r["rejected"]:
            raise AssertionError(f"serve_fleet: rank {r['rank']} completed "
                                 f"{r['completed']} of {r['offered']}")
        if not (r["launches"]["flash_fwd"] and r["launches"]["rmsnorm_fwd"]):
            raise AssertionError(f"serve_fleet: rank {r['rank']} launched "
                                 f"no forward kernel: {r['launches']}")
    if pulled["crcs"] != shipped["crcs"]:
        bad = [k for k in shipped["crcs"]
               if pulled["crcs"].get(k) != shipped["crcs"][k]]
        raise AssertionError(f"serve_fleet: joiner's tensors differ from "
                             f"the donor's: {bad[:5]}")
    if pulled["disk_reads"] != 0 or \
            (pulled["transport"], shipped["transport"]) != ("direct",) * 2:
        raise AssertionError(f"serve_fleet: clone read the disk or left the "
                             f"direct stream: {pulled}, {shipped}")
    probes = {r["rank"]: r["probe"] for r in reps}
    if joiner["probe"] != donor["probe"] or \
            len(donor["probe"]) != FLEET_PROBE_TOKENS:
        raise AssertionError(f"serve_fleet: probe streams differ: {probes}")
    launches = {k: sum(r["launches"][k] for r in reps)
                for k in reps[0]["launches"]}
    lat = ("ttft_p50_ms", "ttft_p99_ms", "token_p50_ms", "token_p99_ms")
    emit("serve_fleet", replicas=len(reps), founders=n,
         qps_per_replica=FLEET_QPS, duration_s=FLEET_DURATION_S,
         cycle_time_ms=2.0, serve={k: serve_rep[k] for k in lat},
         per_rank={r["rank"]: {
             "role": ("joiner" if r is joiner else "donor" if r is donor
                      else "founder"),
             **{k: r[k] for k in ("offered", "completed", "tokens",
                                  "tokens_per_s", "steps", "ticks",
                                  "tick_mean_ms", "tick_p99_ms", *lat,
                                  "max_memory_allocated")},
             "launches": r["launches"]} for r in reps},
         ship_bytes=shipped["bytes"], ship_ms=shipped["ship_ms"],
         pull_bytes=pulled["bytes"], pull_ms=pulled["pull_ms"],
         transport=pulled["transport"], disk_reads=pulled["disk_reads"],
         tensors=len(pulled["crcs"]),
         admission_wait_ms=joiner["admission_wait_ms"],
         join_to_first_token_ms=joiner.get("join_to_first_token_ms"),
         probe_tokens=FLEET_PROBE_TOKENS, probes_equal=len(
             {tuple(p) for p in probes.values()}) == 1,
         launches=launches, seconds=time.monotonic() - t_phase)
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
    checked = set(RMS_CASES)
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


def _per_step(cfg, accumulate: int = 1, width: int = 1) -> dict:
    """Each kernel's launches in one step on one rank: a flash forward, dq
    and dk/dv per layer (under zigzag at width n > 1, 4n: four half-pairs
    at each of n ring steps) and 2L + 1 norms, forward and backward; under
    remat (the context plan's, when the model has one) every block's
    forward (its flash forwards and two norms) runs twice.  A training
    step runs no decode attention."""
    layers, norms = cfg.num_layers, 2 * cfg.num_layers + 1
    flash = layers * (4 * width if width > 1 else 1)
    remat = cfg.remat if cfg.context_plan is None else cfg.context_plan.remat
    fwd, norm_fwd = (2 * flash, norms + 2 * layers) if remat else \
        (flash, norms)
    per = {"decode_attention": 0, "flash_fwd": fwd, "flash_bwd_dq": flash,
           "flash_bwd_dkv": flash, "rmsnorm_fwd": norm_fwd,
           "rmsnorm_bwd": norms}
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


# -- the eager engine path (slice 10) ----------------------------------------

# train_eager_2proc: two processes on the one card, the 162M widths at
# depth 2, B = 2 rows of 1024 tokens a rank (a seed of their own), the
# gather route; 3 steps on Compression.none, then 3 on Compression.int8.
EAGER_2PROC_LAYERS, EAGER_2PROC_BATCH, EAGER_2PROC_STEPS = 2, 2, 3
EAGER_2PROC_TIMEOUT_S = 300.0
# The reduced gradients of the 2-process leg against a host f32 sum of
# both ranks' gradients, on Compression.none.
EAGER_GRAD_REL_L2 = 1e-6


def _eager_trainer(cfg, dev, compression=None):
    """The 162M step's model (seeded weights) and AdamW, wrapped in the
    binding's ``DistributedOptimizer``; parameters and optimizer state
    broadcast from rank 0 through the engine.  Returns ``(model, opt,
    captured)``: while ``captured["on"]``, a hook registered before the
    optimizer's (so it fires first) keeps a copy of each gradient the
    optimizer is about to send, with the int8 wire's carried residual
    added, under the parameter's name."""
    import horovod_tpu_torch.torch as hvdt
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer

    model = Transformer(cfg, device=dev)
    model.load_state_dict(init_params(cfg, SEED))
    hvdt.broadcast_parameters(model.state_dict(), root_rank=0)
    captured = {}

    def capture(name):
        def hook(p):
            if captured.get("on"):
                res = captured["opt"]._residuals.get(id(p))
                g = p.grad.detach().float()
                captured[name] = (g + res if res is not None else g).clone()
        return hook

    for name, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(capture(name))
    opt = hvdt.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=tt.LR,
                          weight_decay=tt.WEIGHT_DECAY),
        named_parameters=model.named_parameters(),
        compression=compression or hvdt.Compression.none)
    captured["opt"] = opt
    hvdt.broadcast_optimizer_state(opt, root_rank=0)
    return model, opt, captured


def _engine_step_stats(before_cache: dict, before_batches: int) -> dict:
    """The engine's work in the step just run: batches, their bytes, and
    the response cache's hits and misses."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.core import executors

    st = executors.stats(wait_device=False)
    cache = basics.cache_stats()
    batches = st["batches"] - before_batches
    return {"batches": batches,
            "bytes": st["bytes"][len(st["bytes"]) - batches:],
            "cache_hits": cache["hits"] - before_cache["hits"],
            "cache_misses": cache["misses"] - before_cache["misses"]}


def _eager_steps(model, opt, tokens, steps: int):
    """``steps`` training steps, each with the engine's work in it."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.core import executors

    losses, per_step = [], []
    for _ in range(steps):
        cache = basics.cache_stats()
        batches = executors.stats(wait_device=False)["batches"]
        losses.append(tt.train_step(model, opt, tokens))
        per_step.append(_engine_step_stats(cache, batches))
    return losses, per_step


def phase_train_eager(train: dict) -> dict:
    """The 162M training step through the eager engine path: ``init`` on
    NCCL at world 1 with ``HVD_TPU_EXECUTOR=multihost`` (the device route
    of ``core/device_reduce.py``, a sum over one rank), the binding's
    ``DistributedOptimizer(AdamW)``: every gradient goes to the engine from
    its post-accumulate-grad hook, is fused, reduced by the executor on its
    own stream, and copied back at ``step()``.

    Checks: the five kernels' launches a step; a falling finite loss; from
    the second step on, a response-cache hit for every gradient tensor;
    and, in a step whose backward waits behind a spin kernel (the hooks
    fire long before the gradients exist on the card), every gradient
    after ``synchronize`` bitwise equal to the one its hook saw."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.core import executors
    from horovod_tpu_torch.utils import trace

    saved = os.environ.get("HVD_TPU_EXECUTOR")
    os.environ["HVD_TPU_EXECUTOR"] = "multihost"
    basics.init()   # NCCL, world 1
    try:
        dev = basics.device()
        cfg = tt.train_config()
        model, opt, captured = _eager_trainer(cfg, dev)
        n_params = sum(p.numel() for p in model.parameters())
        n_tensors = sum(1 for p in model.parameters() if p.requires_grad)
        tokens = tt.token_batch(cfg.vocab_size, dev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        from horovod_tpu_torch.ops import _build

        _build.reset_launches()
        executors.reset_stats()
        losses, per_step = _eager_steps(model, opt, tokens,
                                        tt.WARMUP_STEPS)
        torch.cuda.synchronize()
        executors.reset_stats()
        t0 = time.perf_counter()
        timed, timed_steps = _eager_steps(model, opt, tokens,
                                          tt.TIMED_STEPS)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / tt.TIMED_STEPS
        ex = executors.stats()
        losses = [float(x) for x in losses + timed]
        per_step += timed_steps
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        per = _per_step(cfg)
        _check_steps("train_eager", losses, launches, per)
        hits = [s["cache_hits"] for s in per_step]
        if hits[1:] != [n_tensors] * (len(hits) - 1):
            raise AssertionError(f"train_eager cache hits a step {hits}, "
                                 f"want {n_tensors} from step 2 on")

        # The stream check: backward queued behind ~50 ms of spinning.
        opt.zero_grad(set_to_none=True)
        loss = tt.loss_fn(model, tokens)
        captured["on"] = True
        torch.cuda._sleep(SPIN_CYCLES)
        loss.backward()
        captured["on"] = False
        opt.synchronize()
        mismatched = [n for n, p in model.named_parameters()
                      if not torch.equal(p.grad, captured[n])]
        if mismatched:
            raise AssertionError(f"train_eager: gradients after "
                                 f"synchronize differ from the hooks' "
                                 f"copies: {mismatched[:5]}")
        opt.zero_grad(set_to_none=True)

        with tempfile.TemporaryDirectory() as tmp:
            breakdown = trace.measure(
                "train_eager_step",
                lambda: tt.train_step(model, opt, tokens), 3, tmp)
        tok_s = tt.BATCH * tt.SEQ_LEN / step_s
        emit("train_eager", params=n_params, grad_tensors=n_tensors,
             batch=tt.BATCH, seq_len=tt.SEQ_LEN, processes=basics.size(),
             backend=torch.distributed.get_backend(),
             executor="multihost", route="device", losses=losses,
             step_ms=step_s * 1e3, train_step_ms=train["step_ms"],
             tok_per_s=tok_s,
             mfu=tok_s * tt.flops_per_token(n_params, cfg, tt.SEQ_LEN)
             / PEAK_BF16_FLOPS,
             engine_per_step=per_step,
             executor_host_ms_per_step=ex["host_ms"] / tt.TIMED_STEPS,
             executor_stream_ms_per_step=ex["stream_ms"] / tt.TIMED_STEPS,
             executor_device_ms_per_step=_off_compute_stream_ms(breakdown),
             launches=launches, launches_per_step=per,
             grads_bit_equal_to_hooks=n_tensors,
             max_memory_allocated=peak, breakdown=breakdown)
    finally:
        basics.shutdown()
        if saved is None:
            os.environ.pop("HVD_TPU_EXECUTOR", None)
        else:
            os.environ["HVD_TPU_EXECUTOR"] = saved
    return {"launches": launches, "step_ms": step_s * 1e3}


def _off_compute_stream_ms(breakdown: dict) -> float:
    """Device ms a step on every stream but the step's compute stream (the
    one with the most device time): the executor's copies, sums and
    collectives, on its own stream and NCCL's."""
    by_stream = breakdown["device_ms_by_stream"]
    compute = max(by_stream, key=by_stream.get)
    return sum(ms for s, ms in by_stream.items() if s != compute)


def _param_digests(model) -> list[str]:
    import hashlib

    return [hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for p in model.parameters()]


def eager_worker(rank: int, port: int, cport: int) -> None:
    """One rank of ``train_eager_2proc`` (``chip_smoke.py --eager-worker
    RANK PORT CPORT``): prints one ``EAGER_REPORT`` JSON line."""
    import horovod_tpu_torch.torch as hvdt
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.core import executors
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import trace

    basics.init(device="cuda:0", init_method=f"tcp://localhost:{port}",
                rank=rank, size=2)
    try:
        dev = basics.device()
        cfg = tt.train_config(num_layers=EAGER_2PROC_LAYERS)
        rng = np.random.RandomState(1 + rank)
        tokens = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (EAGER_2PROC_BATCH, tt.SEQ_LEN))).to(dev)
        report = {"rank": rank, "backend": torch.distributed.get_backend(),
                  "host_backend": torch.distributed.get_backend(
                      basics.host_group()), "runs": {}}
        for comp_name in ("none", "int8"):
            comp = getattr(hvdt.Compression, comp_name)
            model, opt, captured = _eager_trainer(cfg, dev, comp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            executors.reset_stats()
            steps = []
            for _ in range(EAGER_2PROC_STEPS):
                captured["on"] = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = tt.train_step(model, opt, tokens)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                captured["on"] = False
                digests = hvdt.allgather_object(_param_digests(model))
                errs = []
                for name, p in model.named_parameters():
                    # Both ranks' gradients (with the carried residual on
                    # the int8 wire), summed on the host in f32.
                    mine = captured[name].reshape(-1).cpu()
                    rows = torch.empty(2 * mine.numel())
                    torch.distributed.all_gather_into_tensor(
                        rows, mine, group=basics.host_group())
                    rows = rows.view(2, -1)
                    want = rows[0] + rows[1]
                    got = 2 * p.grad.float().reshape(-1).cpu()
                    if comp_name == "none":
                        errs.append(float((got - want).norm()
                                          / want.norm()))
                    else:
                        scales = [max(float(r.abs().max()) / 127.0,
                                      float(torch.finfo(torch.float32).tiny))
                                  for r in rows]
                        errs.append(float((got - want).abs().max())
                                    / sum(scales))
                steps.append({"loss": float(loss), "step_ms": step_ms,
                              "params_equal": digests[0] == digests[1],
                              "worst": max(errs)})
            ex, launches = executors.stats(), _launches()
            with tempfile.TemporaryDirectory() as tmp:
                breakdown = trace.measure(
                    f"train_eager_2proc_{comp_name}",
                    lambda: tt.train_step(model, opt, tokens), 1, tmp)
            report["runs"][comp_name] = {
                "steps": steps, "launches": launches,
                "batches": ex["batches"], "bytes": ex["bytes"],
                "executor_host_ms_per_step": ex["host_ms"]
                / EAGER_2PROC_STEPS,
                "executor_stream_ms_per_step": ex["stream_ms"]
                / EAGER_2PROC_STEPS,
                "executor_device_ms_per_step":
                    _off_compute_stream_ms(breakdown),
                "traced_step": {k: breakdown[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "kernels_per_call")},
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            del model, opt, captured
        print("EAGER_REPORT " + json.dumps(report), flush=True)
    finally:
        basics.shutdown()


def phase_train_eager_2proc() -> dict:
    """Two processes on the one card through the eager engine's gather
    route (``HVD_TPU_EAGER_REDUCE=gather``): ``init(device="cuda")``
    forms the NCCL default group, on which nothing runs (NCCL refuses two
    ranks on one device), and the gloo host group that the route stages
    through.  The 162M widths at depth 2, B = 2 a rank.

    Checks, each step: both ranks' parameters bitwise equal; on
    ``Compression.none`` the averaged gradients against a host f32 sum of
    both ranks' (rel. L2 ≤ ``EAGER_GRAD_REL_L2``); on ``Compression.int8``
    the sum's error within the sum of both ranks' scales; both ranks'
    kernels launched per step."""
    from horovod_tpu_torch.serving.soak import free_port

    port, cport = free_port(), free_port()
    env = {**os.environ, "HVD_TPU_EXECUTOR": "multihost",
           "HVD_TPU_EAGER_REDUCE": "gather",
           "HVD_TPU_COORDINATOR_PORT": str(cport)}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--eager-worker",
         str(r), str(port), str(cport)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=EAGER_2PROC_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = next((l for l in out.splitlines()
                     if l.startswith("EAGER_REPORT ")), None)
        if p.returncode != 0 or line is None:
            raise AssertionError(f"train_eager_2proc rank {r} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
        reports.append(json.loads(line.split(" ", 1)[1]))
    from horovod_tpu_torch import train_transformer as tt

    per = _per_step(tt.train_config(num_layers=EAGER_2PROC_LAYERS))
    for rep in reports:
        for comp, run in rep["runs"].items():
            want = {n: c * EAGER_2PROC_STEPS for n, c in per.items()}
            if run["launches"] != want:
                raise AssertionError(f"train_eager_2proc rank "
                                     f"{rep['rank']} {comp}: launches "
                                     f"{run['launches']}, want {want}")
            for i, s in enumerate(run["steps"]):
                bound = EAGER_GRAD_REL_L2 if comp == "none" else 1.0
                if not s["params_equal"] or not s["worst"] <= bound \
                        or not math.isfinite(s["loss"]):
                    raise AssertionError(f"train_eager_2proc rank "
                                         f"{rep['rank']} {comp} step {i}: "
                                         f"{s}")
    emit("train_eager_2proc", processes=2, layers=EAGER_2PROC_LAYERS,
         batch_per_rank=EAGER_2PROC_BATCH, seq_len=tt.SEQ_LEN,
         executor="multihost", route="gather", reports=reports)
    return {"reports": reports}


# train_resume: the 162M step (full width and depth, B = 8) through
# training.elastic_loop under the launcher, async checkpoints every 2 steps
# (max_to_keep 2), 8 steps; the faulted run kills rank 0 at step 5 and
# resumes from step 3's checkpoint.  Checkpoint directories need ~3
# checkpoints of 1.95 GB at once: two kept and one persisting.
RESUME_STEPS, RESUME_EVERY, RESUME_KILL_STEP = 8, 2, 5
RESUME_SNAP_STEP = 3
RESUME_DISK_BYTES = 7 * 10**9
RESUME_TIMEOUT_S = 300.0
# The tolerance where the step is not deterministic on the card: the f32
# training bounds of train (loss) and of one step's parameters.
RESUME_LOSS_ATOL, RESUME_PARAM_REL_L2 = 1e-4, 1e-3
# train_elastic_3proc: three engine-only processes on the card at the 162M
# widths, depth 2, B = 2, the same batch on every rank, a checkpoint every
# step; rank 2 is killed at step 3 of 4.
ELASTIC_LAYERS, ELASTIC_BATCH, ELASTIC_STEPS, ELASTIC_KILL_STEP = 2, 2, 4, 3
ELASTIC_TIMEOUT_S = 240.0
# All three processes on the one card (LOCAL_RANK would name cards 1, 2).
ELASTIC_DEVICE = "cuda:0"
ELASTIC_ENV = {"HVD_TPU_ELASTIC": "1", "HVD_TPU_CKPT_REPLICATE": "1",
               "HVD_TPU_CKPT_ASYNC": "1", "HVD_TPU_HEARTBEAT_MS": "50",
               "HVD_TPU_HEARTBEAT_TIMEOUT_MS": "2000",
               "HVD_TPU_ABORT_GRACE_MS": "300",
               "HVD_TPU_CONNECT_TIMEOUT": "60",
               "HVD_TPU_RECONFIG_TIMEOUT_MS": "30000"}


def _state_crcs(state) -> dict:
    """CRC32 of every tensor's bytes in a training state tree
    (``{"model": state_dict, "optim": state_dict}``), keyed by its path."""
    import zlib

    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(f"{prefix}/{k}", v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        elif isinstance(v, torch.Tensor):
            out[prefix] = zlib.crc32(v.detach().cpu().contiguous().reshape(
                -1).view(torch.uint8).numpy().tobytes())
    walk("", state)
    return out


class _CommitClock:
    """Each save's stall (the call) and persist time (call to commit, read
    off ``last_committed_step`` by a thread polling every millisecond)."""

    def __init__(self, mgr):
        import threading

        self.mgr, self.saves, self._stop = mgr, [], threading.Event()
        self._save = mgr.save
        mgr.save = self.save
        self._t = threading.Thread(target=self._poll, daemon=True)
        self._t.start()

    def save(self, step, state, **kw):
        t0 = time.perf_counter()
        self._save(step, state, **kw)
        self.saves.append({"step": step, "t0": t0,
                           "stall_ms": (time.perf_counter() - t0) * 1e3})

    def _poll(self):
        while not self._stop.is_set():
            last = self.mgr.last_committed_step()
            now = time.perf_counter()
            for s in self.saves:
                if "persist_ms" not in s and last >= s["step"]:
                    s["persist_ms"] = (now - s["t0"]) * 1e3
            time.sleep(0.001)

    def wait_committed(self, step: int, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        while self.mgr.last_committed_step() < step:
            if self.mgr.persist_error() is not None \
                    or time.monotonic() > deadline:
                raise AssertionError(f"step {step} never committed: "
                                     f"{self.mgr.persist_error()}")
            time.sleep(0.005)

    def report(self) -> list:
        time.sleep(0.01)
        self._stop.set()
        self._t.join()
        return [{k: v for k, v in s.items() if k != "t0"}
                for s in self.saves]


def resume_worker(ckpt_dir: str, trace_steps: int, save_final: bool,
                  checkpoints: bool = True) -> None:
    """One attempt of a ``train_resume`` run (``chip_smoke.py
    --resume-worker DIR TRACE SAVE_FINAL CHECKPOINTS`` under ``python -m
    horovod_tpu_torch.run -np 1``): the 162M step as ``elastic_loop``'s
    step function (with a ``CheckpointManager`` unless ``checkpoints`` is
    false), token batches through ``data.BackgroundLoader`` and
    ``data.prefetch_to_device`` seeded by the step index; prints one
    ``RESUME_REPORT`` JSON line."""
    from horovod_tpu_torch import basics, checkpoint, data
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.training import elastic_loop
    from horovod_tpu_torch.utils import trace

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    attempt = int(os.environ.get("HVD_TPU_RESTART_ATTEMPT", "0"))
    basics.init()
    try:
        dev = basics.device()
        t_init = time.time()
        cfg = tt.train_config()
        model, opt = tt.make_trainer(cfg, dev, SEED)
        torch.cuda.synchronize()
        t_model = time.time()
        mgr = checkpoint.CheckpointManager(ckpt_dir, max_to_keep=2) \
            if checkpoints else None
        clock = _CommitClock(mgr) if checkpoints else None
        rep = {"attempt": attempt, "steps": [], "losses": {}, "step_ms": {},
               "backend": torch.distributed.get_backend(),
               "resume_path": checkpoint.resume_path(),
               "start_ts": t_start, "init_s": t_init - t_start,
               "model_s": t_model - t_init}

        def batches(start):
            for s in range(start, RESUME_STEPS):
                rng = np.random.RandomState(SEED + 1 + s)
                yield s, torch.from_numpy(rng.randint(
                    0, cfg.vocab_size, (tt.BATCH, tt.SEQ_LEN)))

        pos = {"next": 0, "it": None}

        def state_of():
            return {"model": model.state_dict(), "optim": opt.state_dict()}

        def step_fn(step, state):
            if pos["it"] is None or pos["next"] != step:
                pos["it"] = data.prefetch_to_device(
                    data.BackgroundLoader(batches(step), depth=2), size=2,
                    device=dev)
            s, tokens = next(pos["it"])
            if s != step:
                raise AssertionError(f"batch of step {s} at step {step}")
            t0 = time.perf_counter()
            loss = float(tt.train_step(model, opt, tokens))
            t1 = time.perf_counter()
            if "first_step_ts" not in rep:
                rep["first_step_ts"] = time.time()
            rep["steps"].append(step)
            rep["losses"][step] = loss
            rep["step_ms"][step] = (t1 - t0) * 1e3
            pos["next"] = step + 1
            if attempt == 0 and step == RESUME_KILL_STEP - 1 \
                    and os.environ.get("HVD_TPU_FAULT_KILL_STEP"):
                # The kill comes at the next step: let the newest save
                # commit first, so the relaunch has it to resume from, and
                # report what this attempt did before it dies.
                clock.wait_committed(RESUME_SNAP_STEP)
                torch.cuda.synchronize()
                rep.update(launches=_launches(), saves=clock.report(),
                           kill_ts=time.time())
                print("RESUME_REPORT " + json.dumps(rep), flush=True)
            return state_of()

        def metadata_fn(step):
            md = {"data_position": step + 1}
            if step == RESUME_SNAP_STEP:
                md["crcs"] = _state_crcs(state_of())
            return md

        def on_resume(ckpt):
            rep["restore_ms"] = (time.perf_counter() - t_loop) * 1e3
            rep["resumed_from"] = ckpt.step
            rep["restore_crcs_equal"] = \
                _state_crcs(ckpt.state) == ckpt.metadata.get("crcs")
            model.load_state_dict(ckpt.state["model"])
            opt.load_state_dict(ckpt.state["optim"])
            rep["loaded_crcs_equal"] = \
                _state_crcs(state_of()) == ckpt.metadata.get("crcs")
            pos["next"] = ckpt.metadata["data_position"]

        torch.cuda.synchronize()
        _build.reset_launches()
        t_loop = time.perf_counter()
        elastic_loop(step_fn, state_of(), num_steps=RESUME_STEPS,
                     manager=mgr, checkpoint_every=RESUME_EVERY,
                     metadata_fn=metadata_fn, on_resume=on_resume)
        torch.cuda.synchronize()
        rep["launches"] = _launches()
        rep["saves"] = clock.report() if clock is not None else []
        rep["final_crcs"] = _state_crcs(state_of())
        step_dir = os.path.join(ckpt_dir, f"step_{RESUME_STEPS - 1}")
        rep["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(step_dir) for f in fs) \
            if checkpoints else None
        rep["state_bytes"] = sum(
            t.numel() * t.element_size()
            for t in _tree_tensors(state_of()))
        rep["persist_error"] = repr(mgr.persist_error()) if mgr else None
        if save_final:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       os.path.join(ckpt_dir, "final_model.pt"))
        if trace_steps:
            tokens = next(batches(0))[1].to(dev)
            with tempfile.TemporaryDirectory() as tmp:
                b = trace.measure("train_resume_step",
                                  lambda: tt.train_step(model, opt, tokens),
                                  trace_steps, tmp)
            rep["trace"] = {k: b[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "kernels_per_call")}
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        print("RESUME_REPORT " + json.dumps(rep), flush=True)
    finally:
        basics.shutdown()


def _tree_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _resume_job(ckpt_dir, *, fault: bool, trace_steps: int = 0,
                save_final: bool = False, checkpoints: bool = True):
    """One ``python -m horovod_tpu_torch.run -np 1`` job of
    :func:`resume_worker`: its reports (one an attempt), the launcher's
    stderr and exit code."""
    env = {**os.environ, "HVD_TPU_CKPT_ASYNC": "1",
           "HVD_TPU_RESTART_BACKOFF": "0.1"}
    flags = []
    if fault:
        env.update({"HVD_TPU_FAULT_KILL_RANK": "0",
                    "HVD_TPU_FAULT_KILL_STEP": str(RESUME_KILL_STEP)})
        flags = ["--max-restarts", "1", "--ckpt-dir", ckpt_dir]
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1", *flags,
         "--", sys.executable, os.path.abspath(__file__), "--resume-worker",
         ckpt_dir, str(trace_steps), "1" if save_final else "0",
         "1" if checkpoints else "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=RESUME_TIMEOUT_S)
    wall_s = time.time() - t0
    reports = [json.loads(l.split("RESUME_REPORT ", 1)[1])
               for l in res.stdout.splitlines() if "RESUME_REPORT " in l]
    if res.returncode != 0 or not reports:
        raise AssertionError(
            f"train_resume job (fault={fault}) exited {res.returncode}:\n"
            f"{res.stdout[-4000:]}\n{res.stderr[-3000:]}")
    return reports, res.stderr, wall_s


def _final_params(ckpt_dir) -> dict:
    return torch.load(os.path.join(ckpt_dir, "final_model.pt"),
                      map_location="cpu")


def phase_train_resume() -> dict:
    """The 162M step through a kill and a restart (see the module
    docstring, ``train_resume``)."""
    from horovod_tpu_torch import train_transformer as tt

    root = tempfile.mkdtemp(prefix="hvd_train_resume_")
    try:
        free = shutil.disk_usage(root).free
        if free < RESUME_DISK_BYTES:
            raise AssertionError(
                f"train_resume needs {RESUME_DISK_BYTES} B free under "
                f"{root} for its checkpoints; {free} B are")
        runs = {}
        # clean_1 checkpoints as the faulted run does; clean_2 does not (a
        # snapshot only copies, so the two runs' steps are the same work).
        for name, kw in (("clean_1", dict(trace_steps=3, save_final=True)),
                         ("clean_2", dict(checkpoints=False))):
            d = os.path.join(root, name)
            os.makedirs(d, exist_ok=True)
            runs[name] = _resume_job(d, fault=False, **kw)
            for entry in os.listdir(d):   # keep final_model.pt only
                if entry.startswith("step_"):
                    shutil.rmtree(os.path.join(d, entry))
        (a1,), _, _ = runs["clean_1"]
        (a2,), _, _ = runs["clean_2"]
        deterministic = a1["final_crcs"] == a2["final_crcs"] \
            and a1["losses"] == a2["losses"]
        d = os.path.join(root, "faulted")
        reports, stderr, _ = _resume_job(d, fault=True,
                                         save_final=not deterministic)
        if len(reports) != 2 or [r["attempt"] for r in reports] != [0, 1]:
            raise AssertionError(f"train_resume faulted run: want attempts "
                                 f"0 and 1, got {reports}\n{stderr[-3000:]}")
        b0, b1 = reports
        if "relaunching attempt 1 from checkpoint" not in stderr \
                or f"step_{RESUME_SNAP_STEP}" not in stderr:
            raise AssertionError(f"train_resume: the launcher did not "
                                 f"restart from step {RESUME_SNAP_STEP}:\n"
                                 f"{stderr[-3000:]}")
        if b0["steps"] != list(range(RESUME_KILL_STEP)) \
                or b1.get("resumed_from") != RESUME_SNAP_STEP \
                or not str(b1["resume_path"]).endswith(
                    f"step_{RESUME_SNAP_STEP}") \
                or b1["steps"] != list(range(RESUME_SNAP_STEP + 1,
                                             RESUME_STEPS)):
            raise AssertionError(f"train_resume steps: attempt 0 "
                                 f"{b0['steps']}, attempt 1 "
                                 f"{b1['steps']} from "
                                 f"{b1.get('resumed_from')}")
        if not (b1["restore_crcs_equal"] and b1["loaded_crcs_equal"]):
            raise AssertionError("train_resume: the restored state is not "
                                 "bitwise the state saved at step "
                                 f"{RESUME_SNAP_STEP}")
        per = _per_step(tt.train_config())
        for tag, r in (("clean_1", a1), ("clean_2", a2), ("attempt 0", b0),
                       ("attempt 1", b1)):
            want = {n: c * len(r["steps"]) for n, c in per.items()}
            if r["launches"] != want:
                raise AssertionError(f"train_resume {tag}: launches "
                                     f"{r['launches']}, want {want}")
        losses = [a1["losses"][str(s)] for s in range(RESUME_STEPS)]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train_resume losses not finite and "
                                 f"falling: {losses}")
        resumed = {s: b1["losses"][s] for s in b1["losses"]}
        loss_diff = max(abs(resumed[s] - a1["losses"][s]) for s in resumed)
        if deterministic:
            agree = b1["final_crcs"] == a1["final_crcs"] and loss_diff == 0
            param_rel_l2 = 0.0 if agree else None
        else:
            mine, ref = _final_params(d), _final_params(
                os.path.join(root, "clean_1"))
            param_rel_l2 = max(float((mine[k].float() - ref[k].float()).norm()
                                     / ref[k].float().norm().clamp_min(1e-30))
                               for k in ref)
            agree = loss_diff <= RESUME_LOSS_ATOL \
                and param_rel_l2 <= RESUME_PARAM_REL_L2
        if not agree:
            raise AssertionError(
                f"train_resume: the resumed run leaves the uninterrupted one "
                f"(deterministic={deterministic}, max |dloss| {loss_diff}, "
                f"param rel L2 {param_rel_l2})")
        if not deterministic:
            diff_params = sorted(k for k in a1["final_crcs"]
                                 if a1["final_crcs"][k] != a2["final_crcs"][k])
        else:
            diff_params = []
        before = [a1["step_ms"][str(s)] for s in range(1, RESUME_KILL_STEP)]
        after = [b1["step_ms"][str(s)]
                 for s in range(RESUME_SNAP_STEP + 2, RESUME_STEPS)]
        launches = {n: sum(r["launches"][n] for r in (a1, a2, b0, b1))
                    for n in per}
        emit("train_resume", layers=12, batch=tt.BATCH, seq_len=tt.SEQ_LEN,
             steps=RESUME_STEPS, checkpoint_every=RESUME_EVERY,
             kill_step=RESUME_KILL_STEP, resumed_from=b1["resumed_from"],
             backend=a1["backend"], deterministic=deterministic,
             params_not_equal_across_clean_runs=diff_params[:20],
             max_abs_loss_diff_resumed_vs_clean=loss_diff,
             param_rel_l2_resumed_vs_clean=param_rel_l2,
             losses_clean=losses, losses_resumed=resumed,
             checkpoint_bytes=a1["checkpoint_bytes"],
             state_bytes=a1["state_bytes"],
             saves_clean_1=a1["saves"], saves_attempt_0=b0["saves"],
             restore_ms=b1["restore_ms"],
             kill_to_first_step_ms=(b1["first_step_ts"] - b0["kill_ts"])
             * 1e3,
             attempt_1_startup_s={
                 "kill_to_process": b1["start_ts"] - b0["kill_ts"],
                 "init": b1["init_s"], "model": b1["model_s"]},
             step_ms_before_kill=before, step_ms_after_resume=after,
             first_step_after_resume_ms=b1["step_ms"][
                 str(RESUME_SNAP_STEP + 1)],
             traced_steps=a1["trace"], launches=launches,
             launches_per_step=per,
             max_memory_allocated=a1["max_memory_allocated"])
        return {"launches": launches, "deterministic": deterministic}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def elastic_worker(rank: int, port: int, n: int, ckpt_dir: str) -> None:
    """One rank of ``train_elastic_3proc`` (``chip_smoke.py
    --elastic-worker RANK PORT N DIR``): an engine-only process on
    ``cuda:0`` with its own ``NativeEngine`` (local executor), the 162M
    widths at depth 2 through ``elastic_loop`` with a replicated, async
    ``CheckpointManager``; prints ``STEP`` lines and one
    ``ELASTIC_REPORT`` JSON line."""
    from horovod_tpu_torch import checkpoint, dataplane, elastic
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.core import engine as em
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.training import elastic_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(ELASTIC_DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0,
                       bulk_port=dataplane.ensure_listener())
    elastic.attach(eng)
    cfg = tt.train_config(num_layers=ELASTIC_LAYERS)
    model = Transformer(cfg, device=dev)
    model.load_state_dict(init_params(cfg, SEED))
    opt = torch.optim.AdamW(model.parameters(), lr=tt.LR,
                            weight_decay=tt.WEIGHT_DECAY)
    params = list(model.parameters())
    rng = np.random.RandomState(SEED + 7)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (ELASTIC_BATCH, tt.SEQ_LEN))).to(dev)
    mgr = checkpoint.CheckpointManager(ckpt_dir, max_to_keep=2, rank=rank,
                                       size=1)
    rep = {"rank": rank, "pid": os.getpid(), "step_fn_calls": 0}

    def state_of():
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def step_fn(step, state):
        rep["step_fn_calls"] += 1
        e = em.peek_engine()  # re-formed between steps after a shrink
        opt.zero_grad(set_to_none=True)
        loss = tt.loss_fn(model, tokens)
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        g = e.synchronize(e.enqueue(f"el.g{step}", flat, OP_ALLREDUCE),
                          timeout_s=120.0)
        with torch.no_grad():
            off = 0
            for p in params:
                p.grad.copy_(g[off:off + p.numel()].view_as(p))
                off += p.numel()
        opt.step()
        rep.setdefault("losses", {})[step] = float(loss)
        print(f"STEP {step} rank={rank} size={e.size} ts={time.time()}",
              flush=True)
        return state_of()

    def metadata_fn(step):
        if step == ELASTIC_KILL_STEP - 1:
            return {"crcs": _state_crcs(state_of())}
        return {}

    def on_resume(ckpt):
        rep["resumed_from"] = ckpt.step
        rep["restore_ms"] = (time.perf_counter() - rep.pop("_t0")) * 1e3 \
            if "_t0" in rep else None
        rep["restore_crcs_equal"] = \
            _state_crcs(ckpt.state) == ckpt.metadata.get("crcs")
        model.load_state_dict(ckpt.state["model"])
        opt.load_state_dict(ckpt.state["optim"])

    @elastic.on_reconfigure
    def _resized(ev):
        rep["resize"] = {"epoch": ev.epoch, "new_rank": ev.new_rank,
                         "new_size": ev.new_size,
                         "failed_rank": ev.failed_rank,
                         "ts": time.time()}
        rep["_t0"] = time.perf_counter()

    save = mgr.save

    def stamped_save(step, state, **kw):
        save(step, state, **kw)
        # The injected kill follows the last save of this rank at once.
        print(f"SAVED {step} rank={rank} ts={time.time()}", flush=True)

    mgr.save = stamped_save
    _build.reset_launches()
    checkpoint.reset_disk_read_count()
    elastic_loop(step_fn, state_of(), num_steps=ELASTIC_STEPS, manager=mgr,
                 checkpoint_every=1, metadata_fn=metadata_fn,
                 on_resume=on_resume)
    torch.cuda.synchronize()
    from horovod_tpu_torch import replication

    final = em.peek_engine()
    rep.update(launches=_launches(), now_pid=os.getpid(), size=final.size,
               disk_reads=checkpoint.disk_read_count(),
               final_crcs=_state_crcs(state_of()),
               replication=replication.replication_stats())
    rep.pop("_t0", None)
    print("ELASTIC_REPORT " + json.dumps(rep), flush=True)
    final.shutdown()


def _elastic_run(root: str, tag: str, kill: bool) -> list:
    from horovod_tpu_torch.serving.soak import free_port

    d = os.path.join(root, tag)
    os.makedirs(d)
    port = free_port()
    env = {**os.environ, **ELASTIC_ENV}
    if kill:
        env.update({"HVD_TPU_FAULT_KILL_RANK": "2",
                    "HVD_TPU_FAULT_KILL_STEP": str(ELASTIC_KILL_STEP)})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--elastic-worker",
         str(r), str(port), "3", d], env={**env, "JAX_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(3)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=ELASTIC_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _elastic_reports(tag, results, ranks) -> dict:
    reps = {}
    for r in ranks:
        rc, out = results[r]
        line = next((l for l in out.splitlines()
                     if l.startswith("ELASTIC_REPORT ")), None)
        if rc != 0 or line is None:
            raise AssertionError(f"train_elastic_3proc {tag} rank {r} "
                                 f"exited {rc}:\n{out[-4000:]}")
        reps[r] = json.loads(line.split(" ", 1)[1])
    return reps


def phase_train_elastic_3proc(deterministic: bool) -> dict:
    """Three engine-only processes on the card; rank 2 SIGKILLed at step
    3; the survivors shrink in place and restore from the peer replica
    (see the module docstring, ``train_elastic_3proc``)."""
    from horovod_tpu_torch import train_transformer as tt

    root = tempfile.mkdtemp(prefix="hvd_train_elastic_")
    try:
        clean = _elastic_reports("clean", _elastic_run(root, "clean", False),
                                 range(3))
        faulted = _elastic_run(root, "faulted", True)
        if faulted[2][0] == 0:
            raise AssertionError("train_elastic_3proc: rank 2 was not "
                                 f"killed:\n{faulted[2][1][-3000:]}")
        reps = _elastic_reports("faulted", faulted, (0, 1))
        out2 = faulted[2][1]
        kill_ts = max(float(l.split("ts=")[1]) for l in out2.splitlines()
                      if l.startswith(f"SAVED {ELASTIC_KILL_STEP - 1} "))
        per = _per_step(tt.train_config(num_layers=ELASTIC_LAYERS))
        recovery = []
        for r, rep in reps.items():
            want = {n: c * rep["step_fn_calls"] for n, c in per.items()}
            ok = (rep["pid"] == rep["now_pid"] and rep["size"] == 2
                  and rep["resize"]["new_size"] == 2
                  and rep["resize"]["failed_rank"] == 2
                  and rep.get("resumed_from") == ELASTIC_KILL_STEP - 1
                  and rep["restore_crcs_equal"] and rep["disk_reads"] == 0
                  and rep["launches"] == want)
            if not ok:
                brief = {k: v for k, v in rep.items() if k != "final_crcs"}
                raise AssertionError(f"train_elastic_3proc survivor {r}: "
                                     f"{brief}, launches want {want}")
            after = [float(l.split("ts=")[1])
                     for l in faulted[r][1].splitlines()
                     if l.startswith(f"STEP {ELASTIC_KILL_STEP} ")]
            recovery.append((min(after) - kill_ts) * 1e3)
        if reps[0]["final_crcs"] != reps[1]["final_crcs"]:
            raise AssertionError("train_elastic_3proc: the survivors' final "
                                 "states differ")
        vs_clean = reps[0]["final_crcs"] == clean[0]["final_crcs"]
        if deterministic and not vs_clean:
            raise AssertionError("train_elastic_3proc: the survivors' final "
                                 "state is not the uninterrupted run's")
        launches = {n: sum(rep["launches"][n] for rep in reps.values())
                    for n in per}
        emit("train_elastic_3proc", processes=3, layers=ELASTIC_LAYERS,
             batch_per_rank=ELASTIC_BATCH, seq_len=tt.SEQ_LEN,
             steps=ELASTIC_STEPS, kill_step=ELASTIC_KILL_STEP,
             executor="local", resized={r: rep["resize"]
                                        for r, rep in reps.items()},
             resumed_from=reps[0]["resumed_from"],
             disk_reads={r: rep["disk_reads"] for r, rep in reps.items()},
             restore_ms={r: rep["restore_ms"] for r, rep in reps.items()},
             recovery_ms=recovery,
             kill_to_reconfigured_ms={
                 r: (rep["resize"]["ts"] - kill_ts) * 1e3
                 for r, rep in reps.items()},
             final_equal_across_survivors=True,
             final_equal_to_uninterrupted=vs_clean,
             replica_bytes_shipped={
                 r: rep["replication"]["bytes_shipped_direct"]
                 + rep["replication"]["bytes_shipped_relay"]
                 for r, rep in reps.items()},
             replication={r: rep["replication"] for r, rep in reps.items()},
             losses={r: rep["losses"] for r, rep in reps.items()},
             launches=launches, launches_per_step=per)
        return {"launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_flash_offsets() -> list:
    """The three flash kernels against their plain versions at the
    long-context path's and ``longctx_audit``'s shapes and offsets
    (:data:`FLASH_OFFSET_ROWS`),
    with times of the
    kernel, the plain version and ``F.scaled_dot_product_attention`` with
    the same boolean mask (its backward for dq and dk/dv), and each
    kernel's bound.  A wholly masked call must give out 0, lse NEG_INF and
    zero gradients, bit for bit, and nothing non-finite."""
    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    for s, h, d in sorted({(s, h, d) for s, _, _, h, d in FLASH_OFFSET_ROWS}):
        q, k, v, dout = (_bshd(gen, 1, s, h, d, False) for _ in range(4))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dout_t = dout.transpose(1, 2).contiguous()
        for q_off, k_off in ((q, k) for r, q, k, rh, rd in FLASH_OFFSET_ROWS
                             if (r, rh, rd) == (s, h, d)):
            visible = _visible(s, s, True, q_off, k_off)
            pairs = int(visible.sum())
            tag = f"flash_offsets S={s} H={h} D={d} q_offset={q_off} " \
                  f"k_offset={k_off}"
            out, lse = fa.flash_attention_with_lse(q, k, v, True, q_off,
                                                   k_off)
            delta = (dout.float() * out.float()).sum(dim=-1)
            args = (q, k, v, dout, lse, delta, True, q_off, k_off)
            got = {"out": out, "lse": lse, "dq": fa.flash_bwd_dq(*args)}
            got["dk"], got["dv"] = fa.flash_bwd_dkv(*args)
            ref_out, ref_lse = fa.flash_attention_reference(
                q, k, v, True, q_off, k_off)
            want = {"out": ref_out, "lse": ref_lse,
                    "dq": fa.flash_bwd_dq_reference(*args)}
            want["dk"], want["dv"] = fa.flash_bwd_dkv_reference(*args)
            torch.cuda.synchronize()
            (atol, rtol), (g_atol, g_rtol) = _flash_tolerances(q.dtype)
            err = {"out": check_close(f"{tag} out", out, ref_out, atol,
                                      rtol),
                   "lse": check_close(f"{tag} lse", lse, ref_lse, LSE_ATOL,
                                      0.0)}
            for name in ("dq", "dk", "dv"):
                err[name] = check_close(f"{tag} {name}", got[name],
                                        want[name], g_atol(want[name]),
                                        g_rtol)
            if not pairs:
                exact = (not bool(got["out"].any())
                         and bool((got["lse"] == fa.NEG_INF).all())
                         and not any(bool(got[n].any())
                                     for n in ("dq", "dk", "dv")))
                if not exact:
                    raise AssertionError(f"{tag}: a wholly masked call "
                                         f"must give out 0, lse NEG_INF "
                                         f"and zero gradients")
            # Bytes: the q rows (with dO, lse and Δ) that see a key and
            # the keys some query sees, read once; every output written
            # once.  A wholly masked call only writes its outputs.
            size = q.element_size()
            rows_q = float(visible.any(dim=1).sum())
            rows_k = float(visible.any(dim=0).sum())
            per_row = size * h * d
            work = {"flash_fwd": (4.0 * h * d * pairs,
                                  per_row * (rows_q + 2 * rows_k)
                                  + per_row * s + 4.0 * s * h),
                    "flash_bwd_dq": (3 * 2.0 * d * h * pairs,
                                     per_row * (2 * rows_q + 2 * rows_k)
                                     + 8.0 * rows_q * h + per_row * s),
                    "flash_bwd_dkv": (4 * 2.0 * d * h * pairs,
                                      per_row * (2 * rows_q + 2 * rows_k)
                                      + 8.0 * rows_q * h + 2 * per_row * s)}
            kernel = {"flash_fwd": lambda: fa.flash_attention_with_lse(
                          q, k, v, True, q_off, k_off),
                      "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args),
                      "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}
            plain = {"flash_fwd": lambda: fa.flash_attention_reference(
                         q, k, v, True, q_off, k_off),
                     "flash_bwd_dq": lambda: fa.flash_bwd_dq_reference(
                         *args),
                     "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_reference(
                         *args)}
            # Offsets set: the boolean mask; none: the library's causal
            # kernel (a mask at S = 32768 would take 1 GB).
            sdpa = _sdpa(True, q_off or k_off, visible)
            with torch.no_grad():
                lib_fwd = time_ms(lambda: sdpa(qt, kt, vt))
            lib_out = sdpa(qt, kt, vt)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dout_t, retain_graph=True))
            del lib_out
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                flops, nbytes = work[name]
                bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
                row = dict(
                    kernel=name, shape=[1, s, h, d], q_offset=q_off,
                    k_offset=k_off, pairs=pairs, wholly_masked=not pairs,
                    max_abs_err=(max(err["out"], err["lse"])
                                 if name == "flash_fwd" else err["dq"]
                                 if name == "flash_bwd_dq"
                                 else max(err["dk"], err["dv"])),
                    kernel_ms=time_ms(kernel[name]),
                    plain_ms=time_ms(plain[name], iters=3, warmup=1),
                    library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
                    library_computes=("the forward" if name == "flash_fwd"
                                      else "dq, dk and dv"),
                    bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                    bytes=nbytes)
                row["share_of_bound"] = bound_ms / row["kernel_ms"]
                emit("flash_offsets", **row)
                rows.append(row)
            del got, want, ref_out, ref_lse, out, lse, delta
        del q, k, v, dout, qt, kt, vt, dout_t
    torch.cuda.empty_cache()
    return rows


def _chunked_loss(logits, tokens, chunks: int):
    """Mean over ``chunks`` equal contiguous chunks of each chunk's
    next-token cross entropy: the zigzag layout's loss over ``chunks / 2``
    ranks, in natural order."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    c = tokens.shape[1] // chunks
    return sum(softmax_cross_entropy(logits[:, i * c:(i + 1) * c - 1],
                                     tokens[:, i * c + 1:(i + 1) * c]).mean()
               for i in range(chunks)) / chunks


def _grad_digest(model) -> dict:
    return {n: p.grad.float().clone() for n, p in model.named_parameters()}


def phase_longctx() -> dict:
    """``train_longseq`` at full width and depth on one process (width 1,
    the plain layout) for each of :data:`LONGCTX_SEQS`: one step through
    the kernels against the same step through the plain versions, then 3
    warm-up and 5 timed steps with exact launches, a falling finite loss,
    tokens/s, MFU, peak memory and one traced step's idle share."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_longseq as tl
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import trace

    basics.init()   # NCCL, world 1: the ring is one flash call a layer
    runs = []
    try:
        dev = basics.device()
        for seq in LONGCTX_SEQS:
            plan = tl.plan_for(seq)
            cfg = tl.longseq_config(plan, seq)
            t0 = time.monotonic()
            model, opt = tl.make_trainer(cfg, dev, SEED)
            build_s = time.monotonic() - t0
            tokens = tl.token_shard(plan, cfg.vocab_size, dev, SEED)
            # One step's loss and gradients through the kernels against
            # the same step through the plain versions, at the seeded
            # weights.
            with plain_versions():
                loss = tl.loss_fn(model, tokens, plan)
                loss.backward()
            plain_loss, plain_grads = float(loss.detach()), \
                _grad_digest(model)
            model.zero_grad(set_to_none=True)
            loss = tl.loss_fn(model, tokens, plan)
            loss.backward()
            check = _grads_vs(model, plain_loss, plain_grads,
                              float(loss.detach()))
            _within_train_bounds(f"longctx S={seq} kernels vs plain", check)
            model.zero_grad(set_to_none=True)
            del plain_grads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            losses = [tl.train_step(model, opt, tokens, plan)
                      for _ in range(tl.WARMUP_STEPS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [tl.train_step(model, opt, tokens, plan)
                       for _ in range(tl.TIMED_STEPS)]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / tl.TIMED_STEPS
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            losses = [float(x) for x in losses]
            per_step = _per_step(cfg)
            steps = tl.WARMUP_STEPS + tl.TIMED_STEPS
            if launches != {n: steps * c for n, c in per_step.items()}:
                raise AssertionError(f"longctx S={seq} launches {launches} "
                                     f"over {steps} steps, want {per_step} "
                                     f"a step")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"longctx S={seq} losses not finite "
                                     f"and falling: {losses}")
            with tempfile.TemporaryDirectory() as tmp:
                breakdown = trace.measure(
                    f"longctx_{seq}",
                    lambda: tl.train_step(model, opt, tokens, plan), 1, tmp)
            tok_s = seq / step_s
            emit("longctx", model="long-context decoder (8 x 2048, 16 heads "
                 "of 128, GLU 8192, vocab 32000, bf16 compute / f32 params, "
                 "f32 logits, RMSNorm kernels)", seq_len=seq,
                 params=sum(p.numel() for p in model.parameters()),
                 processes=basics.size(), build_s=build_s, losses=losses,
                 step_ms=step_s * 1e3, tok_per_s=tok_s,
                 mfu=tok_s * tl.flops_per_token(cfg, seq) / PEAK_BF16_FLOPS,
                 launches=launches, launches_per_step=per_step,
                 max_memory_allocated=peak, step_vs_plain=check,
                 breakdown=breakdown, plan=plan.as_dict())
            runs.append(launches)
            del model, opt, tokens
            torch.cuda.empty_cache()
    finally:
        basics.shutdown()
    return {"launches": {n: sum(r[n] for r in runs) for n in runs[0]}}


def longctx_worker() -> None:
    """One rank of ``longctx_2proc`` (``python -m horovod_tpu_torch.run -np
    2 -- python chip_smoke.py --longctx-worker``): prints one
    ``LONGCTX_REPORT`` JSON line."""
    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_longseq as tl
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import (context_attention_fn,
                                            exchange_stats,
                                            make_ulysses_flash_attention,
                                            plan_long_context,
                                            reset_exchange_stats,
                                            ring_flash_attention_stats)

    # Two ranks on one card: gloo (NCCL refuses two ranks on one device),
    # and the ring's exchange staged through host memory.
    basics.init(device="cuda:0", backend="gloo")
    try:
        dev, rank, n = basics.device(), basics.rank(), basics.size()
        group = tl.context_group()
        solo = [dist.new_group([r]) for r in range(n)][rank]
        seq = LONGCTX_2PROC_SEQ
        plan = tl.plan_for(seq)
        cfg = tl.longseq_config(plan, seq)
        t0 = time.monotonic()
        model, opt = tl.make_trainer(cfg, dev, SEED)
        build_s = time.monotonic() - t0
        tokens = tl.token_shard(plan, cfg.vocab_size, dev, SEED)
        report = {"rank": rank, "backend": dist.get_backend(group),
                  "build_s": build_s, "plan": plan.as_dict()}

        # The width-1 run on the same weights and tokens (natural order,
        # a group of this rank alone, the plain layout), with the zigzag
        # layout's loss over n ranks: the mean of 2n chunks' losses.
        plan1 = plan_long_context(
            seq_len=seq, num_heads=cfg.num_heads, head_dim=cfg.head_dim,
            width=1, embed_dim=cfg.embed_dim, mlp_dim=cfg.mlp_dim,
            num_layers=cfg.num_layers)
        ref = Transformer(tl.longseq_config(plan1, seq, context_axis=solo),
                          device=dev)
        ref.load_state_dict(model.state_dict())
        natural = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, (1, seq))).to(dev)
        ref_loss = _chunked_loss(ref(natural), natural, 2 * n)
        ref_loss.backward()
        ref_loss, ref_grads = float(ref_loss.detach()), _grad_digest(ref)
        del ref
        torch.cuda.empty_cache()

        # Attention alone at the model's widths: the plain layout (pinned)
        # and Ulysses over the group against one flash call on the whole
        # sequence, forward and backward.
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        q, k, v, dout = (_bshd(gen, 1, seq, cfg.num_heads, cfg.head_dim,
                               False) for _ in range(4))
        qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
        fa.flash_attention(qf, kf, vf).backward(dout)
        full = {"out": fa.flash_attention(q, k, v).detach(),
                "dq": qf.grad, "dk": kf.grad, "dv": vf.grad}
        sl = seq // n
        mine = lambda t: t[:, rank * sl:(rank + 1) * sl]  # noqa: E731
        (atol, rtol), (g_atol, g_rtol) = _flash_tolerances(q.dtype)
        plain = plan_long_context(
            seq_len=seq, num_heads=cfg.num_heads, head_dim=cfg.head_dim,
            width=n, layout="plain")
        attn = {"plain": context_attention_fn(group, plain),
                "ulysses": make_ulysses_flash_attention(group)}
        report["attention"] = {}
        for name, fn in attn.items():
            ql, kl, vl = (mine(t).clone().requires_grad_()
                          for t in (q, k, v))
            o = fn(ql, kl, vl)
            o.backward(mine(dout))
            tag = f"longctx_2proc rank {rank} {name}"
            errs = {"out": check_close(f"{tag} out", o, mine(full["out"]),
                                       atol, rtol)}
            for g, t in (("dq", ql), ("dk", kl), ("dv", vl)):
                want = mine(full[g])
                errs[g] = check_close(f"{tag} {g}", t.grad, want,
                                      g_atol(want), g_rtol)
            report["attention"][name] = errs
        _, steps_run = ring_flash_attention_stats(mine(q), mine(k), mine(v),
                                                  group, True)
        report["attention"]["plain"]["steps_run"] = steps_run
        del q, k, v, dout, qf, kf, vf, full

        # One step's loss (averaged over the ranks) and averaged gradients
        # against the width-1 run's.
        model.zero_grad(set_to_none=True)
        loss = tl.loss_fn(model, tokens, plan)
        loss.backward()
        opt.synchronize()
        report["step"] = _grads_vs(model, ref_loss, ref_grads,
                                   float(tl.allreduce(loss.detach())))
        model.zero_grad(set_to_none=True)
        del ref_grads

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        reset_exchange_stats()
        losses, step_ms = [], []
        for _ in range(LONGCTX_2PROC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(tl.train_step(model, opt, tokens, plan)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        report.update(losses=losses, step_ms=step_ms,
                      launches=_launches(),
                      launches_per_step=_per_step(cfg, width=n),
                      exchange=exchange_stats(),
                      max_memory_allocated=torch.cuda.max_memory_allocated())
        print("LONGCTX_REPORT " + json.dumps(report), flush=True)
    finally:
        basics.shutdown()


def phase_longctx_2proc() -> dict:
    """Two processes on the card under ``python -m horovod_tpu_torch.run
    -np 2`` (``--longctx-worker``), width 2, the planned zigzag layout,
    full width and depth at S = 8192.  Checks: the planned layout; on each
    rank, the mean loss and the averaged gradients of one step against the
    width-1 run on the same weights and tokens (the train bounds:
    |Δloss| <= 0.02, each gradient's rel. L2 <= 0.05); the plain layout's
    steps_run == rank + 1; plain and Ulysses attention against one flash
    call on the whole sequence; each rank's launches, 4n of each flash
    kernel a layer a step."""
    from horovod_tpu_torch import train_longseq as tl

    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
           sys.executable, os.path.abspath(__file__), "--longctx-worker"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=LONGCTX_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.monotonic() - t0
    reports = [json.loads(line.split("LONGCTX_REPORT ", 1)[1])
               for line in proc.stdout.splitlines()
               if "LONGCTX_REPORT " in line]
    if proc.returncode != 0 or len(reports) != 2:
        raise AssertionError(f"longctx_2proc exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    reports.sort(key=lambda r: r["rank"])
    per = reports[0]["launches_per_step"]
    if per["flash_bwd_dq"] != 4 * 2 * tl.LAYERS:
        raise AssertionError(f"longctx_2proc: {per} a step, want 4n = 8 "
                             f"flash launches a layer")
    for rep in reports:
        r = rep["rank"]
        if rep["plan"]["layout"] != "zigzag" or rep["backend"] != "gloo":
            raise AssertionError(f"longctx_2proc rank {r}: {rep['plan']}, "
                                 f"{rep['backend']}")
        if rep["attention"]["plain"]["steps_run"] != r + 1:
            raise AssertionError(f"longctx_2proc rank {r}: steps_run "
                                 f"{rep['attention']['plain']}")
        want = {k: c * LONGCTX_2PROC_STEPS for k, c in per.items()}
        if rep["launches"] != want:
            raise AssertionError(f"longctx_2proc rank {r}: launches "
                                 f"{rep['launches']}, want {want}")
        _within_train_bounds(f"longctx_2proc rank {r} against width 1",
                             rep["step"])
        if not all(np.isfinite(rep["losses"])):
            raise AssertionError(f"longctx_2proc rank {r}: {rep['losses']}")
        ex = rep["exchange"]
        ex["bytes_per_exchange"] = ex["bytes"] / max(ex["exchanges"], 1)
        ex["host_ms_per_exchange"] = ex["host_ms"] / max(ex["exchanges"], 1)
    emit("longctx_2proc", processes=2, seq_len=LONGCTX_2PROC_SEQ,
         layers=tl.LAYERS, wall_s=wall_s, launches_per_step=per,
         reports=reports)
    return {"launches": {k: sum(rep["launches"][k] for rep in reports)
                         for k in per}}


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _parallel_leg(tr, steps_fn=None) -> dict:
    """``PARALLEL_WARMUP`` + ``PARALLEL_STEPS`` steps of a trainer, the
    launches and collective calls counted over the timed steps alone:
    losses, host ms a step, launches, calls and peak memory."""
    from horovod_tpu_torch import train_parallel as tp
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.parallel import (collective_stats,
                                            reset_collective_stats)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(tp.train_step(tr)) for _ in range(PARALLEL_WARMUP)]
    digests = []
    _build.reset_launches()
    reset_collective_stats()
    step_ms = []
    for _ in range(PARALLEL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tp.train_step(tr)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if steps_fn is not None:
            digests.append(steps_fn())
    calls = collective_stats()
    out = {"losses": losses, "step_ms": step_ms, "launches": _launches(),
           "calls_per_step": {k: v / PARALLEL_STEPS for k, v in
                              calls.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **tp.memory_bytes(tr)}
    if digests:
        out["param_digests"] = digests
    return out


def _free() -> None:
    """Free a finished leg's trainer before the next leg's peak is read:
    optimizer hooks and FSDP's forward hooks hold their model in
    reference cycles, which only the collector frees."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _memory_phases(tr) -> dict:
    """One more step, its device memory read at each phase: bytes
    allocated at the start, and allocated and peak after the forward
    (the loss), the backward (with the strategy's gradient sync) and the
    optimizer's step."""
    from horovod_tpu_torch import train_parallel as tp

    tr.opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    out = {"start": torch.cuda.memory_allocated()}

    def mark(name):
        torch.cuda.synchronize()
        out[name] = [torch.cuda.memory_allocated(),
                     torch.cuda.max_memory_allocated()]
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    loss = tp.loss_fn(tr)
    mark("forward")
    loss.backward()
    tp.sync_grads(tr)
    del loss
    mark("backward")
    tr.opt.step()
    mark("step")
    return out


def parallel_worker() -> None:
    """One rank of ``parallel_2proc`` (``python -m horovod_tpu_torch.run
    -np 2 -- python chip_smoke.py --parallel-worker``): prints one
    ``PARALLEL_REPORT`` JSON line."""
    import hashlib

    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_parallel as tp
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.parallel import (ParallelMLP, moe_stats,
                                            reset_moe_stats)
    from horovod_tpu_torch.parallel.common import all_gather

    # Two ranks on one card: gloo (NCCL refuses two ranks on one device),
    # every collective's CUDA tensors staged through host memory.
    basics.init(device="cuda:0", backend="gloo")
    rows: set = set()
    try:
        dev, rank = basics.device(), basics.rank()
        group = tp.parallel_group()
        cfg = tt.train_config()
        report = {"rank": rank, "backend": dist.get_backend(group)}
        with record_norm_rows(rows):
            # (a) pipeline: one step's loss and gradients against the
            # sequential 12-block model at world 1 (this rank alone).
            ref = Transformer(cfg, device=dev)
            ref.load_state_dict(init_params(cfg, SEED))
            tokens = tp.token_batch(cfg.vocab_size, tt.BATCH,
                                    cfg.max_seq_len, SEED).to(dev)
            ref_loss, ref_grads = _one_step_grads(ref, tokens)
            del ref
            _free()
            tr = tp.make_trainer("pipeline", cfg, dev, SEED,
                                 microbatches=PARALLEL_MICROBATCHES)
            count = cfg.num_layers // basics.size()
            loss = tp.loss_fn(tr)
            loss.backward()
            tp.sync_grads(tr)
            rel = {}
            for name, p in tr.model.named_parameters():
                glob = name
                if name.startswith("layers."):
                    _, i, rest = name.split(".", 2)
                    glob = f"layers.{int(i) + rank * count}.{rest}"
                rel[glob] = _rel_l2(p.grad, ref_grads[glob])
            worst = max(rel, key=rel.get)
            check = {"loss": float(loss.detach()), "ref_loss": ref_loss,
                     "loss_diff": abs(float(loss.detach()) - ref_loss),
                     "finite": all(bool(torch.isfinite(p.grad).all())
                                   for p in tr.model.parameters()),
                     "grad_rel_l2_max": rel[worst], "worst_param": worst}
            del ref_grads
            report["pipeline"] = {"step": check, **_parallel_leg(tr)}
            del tr
            _free()

            # (b) moe: one expert a rank.
            tr = tp.make_trainer("moe", cfg, dev, SEED)
            reset_moe_stats()
            leg = _parallel_leg(tr)
            leg["moe"] = moe_stats()
            leg["expert_digest"] = hashlib.sha256(
                tr.model.layers[0].moe_mlp.gate.detach().cpu().numpy()
                .tobytes()).hexdigest()
            report["moe"] = leg
            del tr
            _free()

            # (c) zero and (d) fsdp, each against the replicated step.
            tr = tp.make_trainer("replicated", cfg, dev, SEED)
            report["replicated"] = _parallel_leg(tr)
            report["replicated"]["memory_phases"] = _memory_phases(tr)
            del tr
            _free()
            tr = tp.make_trainer("zero", cfg, dev, SEED)
            report["zero"] = _parallel_leg(
                tr, lambda: hashlib.sha256(b"".join(
                    p.detach().cpu().numpy().tobytes()
                    for p in tr.model.parameters())).hexdigest())
            del tr
            _free()
            tr = tp.make_trainer("fsdp", cfg, dev, SEED)
            report["fsdp"] = _parallel_leg(tr)
            # No gathered weight outlives the forward that gathered it.
            loss = tp.loss_fn(tr)
            report["fsdp"]["alive_after_forward"] = \
                tr.fsdp.gathered_alive()
            loss.backward()
            report["fsdp"]["memory_phases"] = _memory_phases(tr)
            del tr
            _free()

        # (e) tp: the ParallelMLP forward and backward against the dense
        # MLP on the gathered weights.
        from horovod_tpu_torch.ops import _build

        mlp = ParallelMLP(cfg.embed_dim, cfg.mlp_dim, cfg.embed_dim,
                          group=group, seed=SEED, device=dev)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        x = torch.randn(PARALLEL_TP_ROWS, cfg.embed_dim, generator=gen,
                        device=dev).to(torch.bfloat16).requires_grad_()
        dout = torch.randn(PARALLEL_TP_ROWS, cfg.embed_dim, generator=gen,
                           device=dev).to(torch.bfloat16)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = mlp(x)
        y.backward(dout)
        torch.cuda.synchronize()
        tp_ms = (time.perf_counter() - t0) * 1e3
        full = [all_gather(mlp.up.kernel.detach(), group, 1),
                all_gather(mlp.up.bias.detach(), group, 0),
                all_gather(mlp.down.kernel.detach(), group, 0),
                mlp.down.bias.detach()]
        dense = [t.clone().requires_grad_() for t in full]
        xd = x.detach().clone().requires_grad_()
        h = torch.nn.functional.gelu(
            xd @ dense[0].to(xd.dtype) + dense[1].to(xd.dtype),
            approximate="tanh")
        yd = h @ dense[2].to(h.dtype) + dense[3].to(h.dtype)
        yd.backward(dout)
        k = basics.size()
        hsl = slice(rank * cfg.mlp_dim // k, (rank + 1) * cfg.mlp_dim // k)
        want = {"y": yd, "dx": xd.grad, "d_up_kernel": dense[0].grad[:, hsl],
                "d_up_bias": dense[1].grad[hsl],
                "d_down_kernel": dense[2].grad[hsl],
                "d_down_bias": dense[3].grad}
        got = {"y": y, "dx": x.grad, "d_up_kernel": mlp.up.kernel.grad,
               "d_up_bias": mlp.up.bias.grad,
               "d_down_kernel": mlp.down.kernel.grad,
               "d_down_bias": mlp.down.bias.grad}
        report["tp"] = {"rows": PARALLEL_TP_ROWS, "ms": tp_ms,
                        "launches": _launches(),
                        "rel_l2": {n: _rel_l2(got[n], want[n])
                                   for n in want}}
        report["norm_rows"] = sorted([str(dt), n, e] for dt, n, e in rows)
        print("PARALLEL_REPORT " + json.dumps(report), flush=True)
    finally:
        basics.shutdown()


def phase_parallel_2proc(norm_rows: set) -> dict:
    """Two processes on the card under ``python -m horovod_tpu_torch.run
    -np 2`` (``--parallel-worker``), gloo, the 162M decoder at full width:
    (a) the GPipe pipeline, 2 stages of 6 blocks, 4 microbatches: one
    step's loss and gradients against the sequential 12-block model on the
    same weights and batch (the train bounds); (b) MoE over both ranks: a
    finite, falling loss, the tokens dropped, distinct experts; (c) ZeRO-1:
    parameters bitwise equal across ranks after each step, optimizer state
    a rank half the replicated step's, losses within the train bound of
    the replicated ``DistributedOptimizer``'s; (d) FSDP: parameter,
    gradient and state bytes a rank half the replicated step's, peak
    memory, losses likewise; (e) tensor parallel: ``ParallelMLP`` 768 ->
    3072 -> 768 over [8192, 768] bf16, forward and backward, against the
    dense MLP on the gathered weights (rel. L2 within the train bound).
    Each leg's launches are exact: 6 blocks x 4 microbatches a stage, 12
    blocks otherwise.  The RMSNorm rows the legs launched join
    ``norm_rows``."""
    from horovod_tpu_torch import train_transformer as tt

    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
           sys.executable, os.path.abspath(__file__), "--parallel-worker"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=PARALLEL_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.monotonic() - t0
    reports = [json.loads(line.split("PARALLEL_REPORT ", 1)[1])
               for line in proc.stdout.splitlines()
               if "PARALLEL_REPORT " in line]
    if proc.returncode != 0 or len(reports) != 2:
        raise AssertionError(f"parallel_2proc exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    reports.sort(key=lambda r: r["rank"])
    cfg = tt.train_config()
    whole = _per_step(cfg)
    stage = {n: c * PARALLEL_MICROBATCHES * (cfg.num_layers // 2)
             // cfg.num_layers for n, c in whole.items()}
    # Each stage's norms: 2 a block a microbatch, and the final norm over
    # the whole batch on every rank.
    stage["rmsnorm_fwd"] = stage["rmsnorm_bwd"] = \
        2 * (cfg.num_layers // 2) * PARALLEL_MICROBATCHES + 1
    per = {"pipeline": stage, "moe": whole, "replicated": whole,
           "zero": whole, "fsdp": whole}
    launches = collections.Counter()
    for rep in reports:
        r = rep["rank"]
        if rep["backend"] != "gloo":
            raise AssertionError(f"parallel_2proc rank {r}: {rep['backend']}")
        _within_train_bounds(f"parallel_2proc rank {r} pipeline against "
                             f"the sequential model",
                             rep["pipeline"]["step"])
        for leg, want in per.items():
            got = rep[leg]["launches"]
            if got != {n: c * PARALLEL_STEPS for n, c in want.items()}:
                raise AssertionError(f"parallel_2proc rank {r} {leg}: "
                                     f"launches {got}, want {want} a step")
            if not all(np.isfinite(rep[leg]["losses"])):
                raise AssertionError(f"parallel_2proc rank {r} {leg}: "
                                     f"{rep[leg]['losses']}")
            if leg != "replicated":
                launches.update(got)
        moe = rep["moe"]
        if not moe["losses"][-1] < moe["losses"][0]:
            raise AssertionError(f"parallel_2proc moe losses not falling: "
                                 f"{moe['losses']}")
        repl = rep["replicated"]
        for leg in ("zero", "fsdp"):
            diff = max(abs(a - b) for a, b in zip(rep[leg]["losses"],
                                                  repl["losses"]))
            rep[leg]["loss_diff_vs_replicated"] = diff
            rep[leg]["state_share"] = rep[leg]["state_bytes"] / \
                repl["state_bytes"]
            if diff > TRAIN_LOSS_ATOL or not 0.45 <= \
                    rep[leg]["state_share"] <= 0.55:
                raise AssertionError(f"parallel_2proc rank {r} {leg}: "
                                     f"|dloss| {diff}, state share "
                                     f"{rep[leg]['state_share']}")
        fsdp = rep["fsdp"]
        fsdp["bytes_share"] = sum(fsdp[k] for k in (
            "param_bytes", "grad_bytes", "state_bytes")) / sum(
            repl[k] for k in ("param_bytes", "grad_bytes", "state_bytes"))
        if not 0.45 <= fsdp["bytes_share"] <= 0.55 \
                or fsdp["alive_after_forward"]:
            raise AssertionError(
                f"parallel_2proc rank {r} fsdp: bytes share "
                f"{fsdp['bytes_share']}, gathered weights alive "
                f"{fsdp['alive_after_forward']}")
        worst = max(rep["tp"]["rel_l2"].values())
        if worst > TRAIN_GRAD_REL_L2:
            raise AssertionError(f"parallel_2proc rank {r} tp: "
                                 f"{rep['tp']['rel_l2']}")
        launches.update(rep["tp"]["launches"])
        norm_rows.update((getattr(torch, dt.split(".")[-1]), n, e)
                         for dt, n, e in rep["norm_rows"])
    zero = [rep["zero"]["param_digests"] for rep in reports]
    if zero[0] != zero[1]:
        raise AssertionError("parallel_2proc zero: parameters differ across "
                             "ranks after a step")
    if reports[0]["moe"]["expert_digest"] == \
            reports[1]["moe"]["expert_digest"]:
        raise AssertionError("parallel_2proc moe: the two experts are one")
    emit("parallel_2proc", processes=2, layers=cfg.num_layers,
         batch=tt.BATCH, seq_len=cfg.max_seq_len,
         microbatches=PARALLEL_MICROBATCHES, steps=PARALLEL_STEPS,
         wall_s=wall_s, launches_per_step=per, reports=reports)
    return {"launches": dict(launches)}


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


def _no_port_kernel(phase: str, launches: dict) -> None:
    if any(launches.values()):
        raise AssertionError(f"{phase}: a port kernel launched on a path "
                             f"that has none: {launches}")


def phase_cnn() -> dict:
    """VGG-16 and Inception V3 (the aux head on: loss = head + 0.4·aux)
    through ``train_synthetic``'s step at full width and depth on the card,
    NCCL world 1, ``CNN_BATCH`` images at each model's canonical size, 3
    warm-up and 8 timed steps: parameters, img/s, step ms, peak memory, a
    finite loss falling on the fixed batch, the width-1 bypass,
    ``utils/trace.measure``'s breakdown with BatchNorm's share of the
    device time, and the port kernels' launches, 0 each (convolutions and
    BatchNorms are cuDNN's and PyTorch's)."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_synthetic as ts
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.schedule_plan import overlap_plan
    from horovod_tpu_torch.utils import trace

    basics.init()   # NCCL, world 1
    launches = collections.Counter()
    try:
        torch.backends.cudnn.benchmark = True
        dev = basics.device()
        for name, kw in CNN_MODELS:
            size = ts.image_size(name)
            t0 = time.monotonic()
            model, opt = ts.make_trainer(dev, SEED, model=name, **kw)
            x, y = ts.synthetic_batch(CNN_BATCH, dev, size)
            setup_s = time.monotonic() - t0
            n_params = sum(p.numel() for p in model.parameters())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # What earlier phases of this process still hold, so the
            # model's own peak is the difference.
            held = torch.cuda.memory_allocated() - sum(
                t.numel() * t.element_size() for t in
                list(model.parameters()) + list(model.buffers()) + [x, y])
            _build.reset_launches()
            losses = [ts.train_step(model, opt, x, y)
                      for _ in range(CNN_WARMUP)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [ts.train_step(model, opt, x, y)
                       for _ in range(CNN_STEPS)]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / CNN_STEPS
            run = _launches()
            peak = torch.cuda.max_memory_allocated()
            losses = [float(v) for v in losses]
            plan = overlap_plan()
            _no_port_kernel(f"cnn {name}", run)
            launches.update(run)
            if not _is_bypass(plan):
                raise AssertionError(f"cnn {name} overlap plan: {plan}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"cnn {name} losses not finite and "
                                     f"falling: {losses}")
            with tempfile.TemporaryDirectory() as tmp:
                breakdown = trace.measure(
                    f"{name}_step", lambda: ts.train_step(model, opt, x, y),
                    3, tmp)
            by_kind = breakdown["device_ms_by_kind"]
            busy = breakdown["device_busy_ms"]
            emit("cnn", model=f"{name} (1000 classes, bf16 compute / f32 "
                 f"params, channels-last, dropout 0)", options=kw,
                 loss="head + 0.4 * aux" if kw.get("aux_logits") else
                 "head", params=n_params, batch=CNN_BATCH,
                 image=[size, size, 3], processes=basics.size(),
                 setup_s=setup_s, losses=losses, step_ms=step_s * 1e3,
                 img_per_s=CNN_BATCH / step_s, max_memory_allocated=peak,
                 held_by_earlier_phases=held, peak_of_model=peak - held,
                 batchnorm_share_of_busy=by_kind.get("batchnorm", 0.0)
                 / busy, conv_share_of_busy=by_kind.get("conv", 0.0) / busy,
                 breakdown=breakdown, launches=run, overlap_plan=plan)
            del model, opt, x, y
            _free()
    finally:
        basics.shutdown()
    return {"launches": dict(launches)}


def _bn_digest(model) -> str:
    """sha256 of every BatchNorm's running mean and variance, in order."""
    import hashlib

    from horovod_tpu_torch.models.resnet import BatchNorm

    return hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes() for m in model.modules()
        if isinstance(m, BatchNorm) for t in (m.mean, m.var))).hexdigest()


def sync_bn_worker() -> None:
    """One rank of ``sync_bn_2proc`` (``python -m horovod_tpu_torch.run
    -np 2 -- python chip_smoke.py --sync-bn-worker``): prints one
    ``SYNC_BN_REPORT`` JSON line."""
    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch import train_synthetic as ts
    from horovod_tpu_torch.models.convert import init_state
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    # Two ranks on one card: gloo (NCCL refuses two ranks on one device).
    basics.init(device="cuda:0", backend="gloo")
    try:
        dev, rank = basics.device(), basics.rank()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        n = SYNC_BN_BATCH * basics.size()
        xs = torch.randn(n, ts.IMAGE, ts.IMAGE, 3, generator=gen, device=dev)
        ys = torch.randint(0, ts.NUM_CLASSES, (n,), generator=gen,
                           device=dev)
        rows = slice(rank * SYNC_BN_BATCH, (rank + 1) * SYNC_BN_BATCH)
        report = {"rank": rank, "backend": dist.get_backend()}
        ref_grads = None
        if rank == 0:
            # One process on the whole batch with local BatchNorm (built
            # here alone: make_trainer's broadcast would wait for rank 1).
            ref = ts.build_model("ResNet50", dev)
            ref.load_state_dict(init_state(ref, SEED))
            ref = ref.to(memory_format=torch.channels_last)
            loss = softmax_cross_entropy(ref(xs, train=True), ys).mean()
            loss.backward()
            report["ref_loss"] = float(loss)
            ref_grads = {k: p.grad.float() for k, p in ref.named_parameters()}
            del ref, loss
            _free()
        _build.reset_launches()
        for leg, group in (("sync", dist.group.WORLD), ("local", None)):
            model, opt = ts.make_trainer(dev, SEED, process_group=group)
            out = {"losses": [], "stats_digests": [], "step_ms": []}
            for step in range(SYNC_BN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = ts.train_step(model, opt, xs[rows], ys[rows])
                out["losses"].append(float(loss))
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["stats_digests"].append(_bn_digest(model))
                if step == 0 and leg == "sync" and ref_grads is not None:
                    # The averaged gradients the step applied: relative L2
                    # over all of them, and the worst tensor's.
                    rel = {k: _rel_l2(p.grad, ref_grads[k])
                           for k, p in model.named_parameters()}
                    worst = max(rel, key=rel.get)
                    diff = sum(float((p.grad.float() - ref_grads[k])
                                     .square().sum())
                               for k, p in model.named_parameters())
                    norm = sum(float(g.square().sum())
                               for g in ref_grads.values())
                    out["grad_rel_l2"] = (diff / norm) ** 0.5
                    out["grad_rel_l2_max"] = rel[worst]
                    out["worst_param"] = worst
            report[leg] = out
            del model, opt
            _free()
        report["launches"] = _launches()
        print("SYNC_BN_REPORT " + json.dumps(report), flush=True)
    finally:
        basics.shutdown()


def phase_sync_bn_2proc() -> dict:
    """Two processes on the card under ``python -m horovod_tpu_torch.run
    -np 2`` (``--sync-bn-worker``), gloo: ResNet-50 with cross-replica
    BatchNorm (``process_group=WORLD``), ``SYNC_BN_BATCH`` images a rank of
    one seeded batch, ``SYNC_BN_STEPS`` steps through ``train_synthetic``'s
    step.  Checks: every BatchNorm's running mean and variance bitwise
    equal across the ranks after each step, and not so with local
    BatchNorm (the sync path is live); step 1's mean loss over the ranks
    and its averaged gradients against one process on the whole batch with
    local BatchNorm (the train bounds); finite losses; no port kernel."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
           sys.executable, os.path.abspath(__file__), "--sync-bn-worker"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=SYNC_BN_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.monotonic() - t0
    reports = [json.loads(line.split("SYNC_BN_REPORT ", 1)[1])
               for line in proc.stdout.splitlines()
               if "SYNC_BN_REPORT " in line]
    if proc.returncode != 0 or len(reports) != 2:
        raise AssertionError(f"sync_bn_2proc exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    reports.sort(key=lambda r: r["rank"])
    launches = collections.Counter()
    for rep in reports:
        if rep["backend"] != "gloo":
            raise AssertionError(f"sync_bn_2proc: {rep['backend']}")
        _no_port_kernel("sync_bn_2proc", rep["launches"])
        launches.update(rep["launches"])
        for leg in ("sync", "local"):
            if not all(np.isfinite(rep[leg]["losses"])):
                raise AssertionError(f"sync_bn_2proc {leg}: "
                                     f"{rep[leg]['losses']}")
    sync = [rep["sync"]["stats_digests"] for rep in reports]
    local = [rep["local"]["stats_digests"] for rep in reports]
    if sync[0] != sync[1]:
        raise AssertionError("sync_bn_2proc: running statistics differ "
                             "across ranks with cross-replica BatchNorm")
    if any(a == b for a, b in zip(*local)):
        raise AssertionError("sync_bn_2proc: local BatchNorm gave equal "
                             "running statistics on both ranks")
    mean_loss = sum(rep["sync"]["losses"][0] for rep in reports) / 2
    sync0 = reports[0]["sync"]
    check = {"loss": mean_loss, "ref_loss": reports[0]["ref_loss"],
             "loss_diff": abs(mean_loss - reports[0]["ref_loss"]),
             "grad_rel_l2": sync0["grad_rel_l2"],
             "grad_rel_l2_max": sync0["grad_rel_l2_max"],
             "worst_param": sync0["worst_param"]}
    # The train bounds, the gradient's over all parameters: one BatchNorm
    # scale or bias gradient is a sum of ~50k bf16 products that cancel,
    # and alone it moves by up to ~10% between two correct roundings (a
    # CPU rehearsal at 8 images of 112² a rank: bn_init.bias 0.105, all
    # parameters 0.0115; in f32, 1.9e-3).
    if check["loss_diff"] > TRAIN_LOSS_ATOL \
            or check["grad_rel_l2"] > TRAIN_GRAD_REL_L2:
        raise AssertionError(f"sync_bn_2proc step 1 against the whole "
                             f"batch: {check}, bounds {TRAIN_LOSS_ATOL}, "
                             f"{TRAIN_GRAD_REL_L2}")
    emit("sync_bn_2proc", processes=2, model="ResNet-50 v1.5, bf16, "
         "cross-replica BatchNorm", batch_per_rank=SYNC_BN_BATCH,
         steps=SYNC_BN_STEPS, wall_s=wall_s, step_1=check, reports=reports)
    return {"launches": dict(launches)}


def phase_profile() -> dict:
    """``horovod_tpu_torch.profiling.trace`` around ``PROFILE_STEPS`` steps
    of the 162M training step (each inside ``annotate("train_step")``),
    after one untraced step: the Chrome trace must exist and hold the span
    and a kernel of each of the five port kernels; its bytes and the
    launches (exact a step)."""
    import glob

    from horovod_tpu_torch import basics, profiling
    from horovod_tpu_torch import train_transformer as tt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.utils import trace

    basics.init()   # NCCL, world 1
    try:
        dev = basics.device()
        cfg = tt.train_config()
        model, opt = tt.make_trainer(cfg, dev, SEED)
        tokens = tt.token_batch(cfg.vocab_size, dev)
        tt.train_step(model, opt, tokens)
        torch.cuda.synchronize()
        _build.reset_launches()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with profiling.trace(tmp):
                for _ in range(PROFILE_STEPS):
                    with profiling.annotate("train_step"):
                        tt.train_step(model, opt, tokens)
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
            launches = _launches()
            (path,) = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
            size = os.path.getsize(path)
            events = trace._events(path)
            spans = sum(1 for e in events if e.get("name") == "train_step"
                        and e.get("ph") == "X")
            kinds = collections.Counter(
                trace.kind_of(e["name"]) for e in trace.device_events(path))
        want = {k: c * PROFILE_STEPS for k, c in _per_step(cfg).items()}
        if launches != want:
            raise AssertionError(f"profile launches {launches}, want {want}")
        missing = [k for k, n in want.items() if n and not kinds.get(k)]
        if spans < PROFILE_STEPS or missing:
            raise AssertionError(f"profile trace: {spans} train_step spans, "
                                 f"no kernel of {missing}")
        emit("profile", trace_file=os.path.basename(path), trace_bytes=size,
             steps=PROFILE_STEPS, train_step_spans=spans,
             traced_s=traced_s, device_kernels_by_kind=dict(kinds),
             launches=launches)
        del model, opt
        _free()
    finally:
        basics.shutdown()
    return {"launches": launches}


def phase_control_plane() -> None:
    """The native tools of ``horovod_tpu_torch/core/src/tools``, built by
    ``core/_build.py`` (``phase_build`` starts them beside the kernels):
    ``fleet_sim`` at the JAX core Makefile's fleet-soak settings and
    ``star_bench`` at P = 8.  Host programs: no device work."""
    from horovod_tpu_torch.core import _build, tools

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(_build.TOOLS)) as pool:
        list(pool.map(_build.build_tool, _build.TOOLS))
    build_s = time.monotonic() - t0
    sim = tools.fleet_sim(FLEET_SIM["p"], FLEET_SIM["ticks"],
                          fanout=FLEET_SIM["fanout"])
    star = tools.star_bench(STAR_BENCH_P, STAR_BENCH_TICKS)
    if not sim["ok"] or sim["agg_frames_per_tick"] != sim["num_groups"]:
        raise AssertionError(f"fleet_sim: {sim}")
    if not star["tick_us"] > 0:
        raise AssertionError(f"star_bench: {star}")
    emit("control_plane", build_s=build_s, fleet_sim=sim, star_bench=star)


EXAMPLES_TIMEOUT_S = 300
# int8_convergence on the port's wire (±127 levels a worker): how far an
# int8 run's mean loss may stray from the f32 run's at a recorded step (at
# width 64 on the CPU they agree to 2e-4 over 40 steps).
INT8_F32_GAP = 0.01


def _example(np_: int, module: str, *args: str) -> tuple[list[str], float]:
    """Run ``python -m horovod_tpu_torch.examples.<module>`` under the
    launcher; its output lines without the launcher's rank tags, and its
    seconds.  A child that fails fails the phase."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
           "--", sys.executable, "-m", f"horovod_tpu_torch.examples.{module}",
           *args]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=EXAMPLES_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"examples: {module} exited {proc.returncode}:"
                             f"\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = [line.split("]: ", 1)[1] if line.startswith("[") and "]: " in
             line else line for line in proc.stdout.splitlines()]
    return lines, wall_s


def _json_rows(lines) -> list[dict]:
    return [json.loads(line) for line in lines if line.startswith("{")]


def _expect(module: str, lines, *needles: str) -> None:
    text = "\n".join(lines)
    for needle in needles:
        if needle not in text:
            raise AssertionError(f"examples: {module} printed no "
                                 f"{needle!r}:\n{text[-3000:]}")


def _final_loss(module: str, lines, np_: int = 1) -> float:
    finals = [line for line in lines if f"/{np_}] final loss=" in line]
    if len(finals) != np_:
        raise AssertionError(f"examples: {module}: {finals}")
    loss = float(finals[0].split("final loss=", 1)[1].split()[0])
    if not math.isfinite(loss):
        raise AssertionError(f"examples: {module}: final loss {loss}")
    return loss


def _check_mnist(lines) -> dict:
    _expect("mnist", lines, "epoch 0: loss=")
    return {"mnist_final_loss": _final_loss("mnist", lines)}


def _check_word2vec(lines) -> dict:
    _expect("word2vec", lines, "step 0: loss=", "step 10: loss=")
    return {"word2vec_final_loss": _final_loss("word2vec", lines)}


def _check_mnist_advanced(lines) -> dict:
    _expect("mnist_advanced", lines, "epoch 0: {'loss': ",
            "finished gradual learning rate warmup", "epoch 3: {'loss': ")
    return {"mnist_advanced_final_loss": _final_loss("mnist_advanced",
                                                     lines)}


def _check_int8(lines) -> dict:
    """The port's wire at width 64: three trajectories of finite losses
    from the same start, the int8 runs within INT8_F32_GAP of the f32 one
    at every recorded step."""
    (row,) = _json_rows(lines)
    runs = [row[m] for m in ("f32", "int8_ef", "int8_noef")]
    if not (row["wire"] == "qwire" and row["per_worker_levels"] == 127
            and row["card"] and len({len(r) for r in runs}) == 1
            and all(math.isfinite(x) for r in runs for x in r)
            and runs[1][0] == runs[0][0] == runs[2][0]
            and all(abs(a - b) <= INT8_F32_GAP for r in runs[1:]
                    for a, b in zip(r, runs[0]))):
        raise AssertionError(f"examples: int8_convergence: {row}")
    return {"int8_convergence": {k: row[k] for k in (
        "width", "wire", "steps", "f32", "int8_ef", "int8_noef")}}


def _check_torch_mnist(lines) -> dict:
    _expect("torch_mnist", lines, "epoch 0: loss=")
    return {"torch_mnist_final_loss": _final_loss("torch_mnist", lines)}


def _check_synthetic(lines) -> dict:
    _expect("torch_synthetic_benchmark", lines, "Img/sec per worker:",
            "Total img/sec on 1 worker(s)")
    return {"torch_synthetic_img_s": float(
        [line for line in lines if line.startswith("Img/sec per worker:")]
        [0].split()[3])}


def _check_overlap_audit(lines) -> dict:
    (row,) = _json_rows(lines)
    if not (_is_bypass(row["plan"]) and row["optimizer_hooks"] == 0
            and row["buckets_issued"] == []):
        raise AssertionError(f"examples: overlap_audit at world 1: {row}")
    return {"overlap_audit": {k: row[k] for k in (
        "plan", "optimizer_hooks", "buckets_issued")}}


def _check_star(lines) -> dict:
    stars = _json_rows(lines)
    if [r["p"] for r in stars] != [8, 64] or not all(
            r["tick_us"] > 0 for r in stars):
        raise AssertionError(f"examples: --star: {stars}")
    return {"star_bench": stars}


def _check_longctx_audit(lines) -> dict:
    """The audit passed and launched the three flash kernels, each call
    at a shape and offsets that ``phase_flash_offsets`` held against the
    plain versions (contiguous bf16 inputs, causal)."""
    (row,) = _json_rows(lines)
    launches = row["launches"]
    if row["failures"] or not all(
            launches[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
        raise AssertionError(f"examples: longctx_audit: {row['failures']}, "
                             f"{launches}")
    checked = {(kind, 1, s, s, h, d, "bfloat16", True, q, k, True)
               for kind in ("fwd", "bwd")
               for s, q, k, h, d in FLASH_OFFSET_ROWS}
    calls = {tuple(c) for c in row["flash_calls"]}
    if not calls or calls - checked:
        raise AssertionError(f"examples: longctx_audit called the flash "
                             f"kernels at {sorted(calls - checked)}, which "
                             f"phase_flash_offsets does not check")
    return {"longctx_audit": {"step_skip": row["step_skip"],
                              "launches": launches,
                              "flash_calls": len(calls)}}


def _check_collectives(lines) -> dict:
    rows = _json_rows(lines)
    sizes = [r for r in rows if "size_mb" in r]
    floor = [r for r in rows if "dispatch_floor_ms" in r]
    if [r["size_mb"] for r in sizes] != [1.0, 16.0, 256.0] or len(floor) \
            != 1 or any(r["backend"] != "nccl" for r in rows) or not all(
            r["all_reduce_ms"] > 0 and r["all_gather_ms"] > 0
            for r in sizes):
        raise AssertionError(f"examples: collective_microbench: {rows}")
    return {"collective_microbench": rows}


def _check_control_plane(lines) -> dict:
    (row,) = [r for r in _json_rows(lines) if "per_op_ms" in r]
    if not (row["np"] == 1 and row["per_op_ms"] > 0
            and row["names_per_s"] > 0):
        raise AssertionError(f"examples: control_plane_benchmark: {row}")
    return {"control_plane": row}


def _check_weak_scaling(lines) -> dict:
    (row,) = _json_rows(lines)
    if not (row["workers"] == 1 and row["steps_per_s_per_rank"] > 0
            and row["wire_model_mb_per_rank_per_step"] == 0.0):
        raise AssertionError(f"examples: weak_scaling_benchmark: {row}")
    return {"weak_scaling": row}


def _check_resnet_bn(lines) -> dict:
    (row,) = _json_rows(lines)
    for leg in ("stats", "nostats"):
        r = row[leg]
        if not (r["img_s"] > 0 and all(map(math.isfinite, r["losses"]))
                and r["device_busy_ms"] > 0
                and r["device_ms_by_kind"].get("conv", 0) > 0):
            raise AssertionError(f"examples: resnet_bn_experiment {leg}: "
                                 f"{r}")
    return {"resnet_bn": row}


def _check_imagenet(lines) -> dict:
    _expect("imagenet_resnet50", lines, "epoch 0: loss=")
    _final_loss("imagenet_resnet50", lines)
    return {}


def _check_imagenet_resume(lines) -> dict:
    _expect("imagenet_resnet50", lines, "resumed from epoch 0",
            "epoch 1: loss=")
    if any(line.startswith("epoch 0:") for line in lines):
        raise AssertionError("examples: the resumed run trained epoch 0")
    _final_loss("imagenet_resnet50", lines)
    return {"imagenet_img_s": float(
        [line for line in lines if line.startswith("epoch 1:")][0]
        .split()[-2])}


def phase_examples() -> dict:
    """The example entry points on the card (see the module docstring);
    the launches of ``longctx_audit``'s ranks, for the kernels line.

    The children whose only output is a correctness check (with
    ``weak_scaling_benchmark``, whose rate PERF.md does not read) run five
    at a time, each spending most of its seconds reaching the card, the
    first ``imagenet_resnet50`` run among them; the ones whose numbers
    PERF.md reads run alone, one after another, the resumed
    ``imagenet_resnet50`` run first."""
    t0 = time.monotonic()
    seconds, out = {}, {}
    ckpt = tempfile.mkdtemp(prefix="hvd_smoke_examples_")
    r50 = ("--steps-per-epoch", "2", "--batch-size", "32", "--ckpt-dir",
           os.path.join(ckpt, "r50"))
    # Longest first: the stage lasts at least as long as its longest
    # child.
    checked = [
        ("imagenet_resnet50", 1, "imagenet_resnet50", ("--epochs", "1")
         + r50, _check_imagenet),
        ("torch_mnist", 1, "torch_mnist",
         ("--epochs", "1", "--ckpt-dir", os.path.join(ckpt, "tmnist")),
         _check_torch_mnist),
        ("torch_synthetic_benchmark", 1, "torch_synthetic_benchmark",
         ("--model", "convnet"), _check_synthetic),
        ("mnist", 1, "mnist", ("--epochs", "1", "--ckpt-dir",
                               os.path.join(ckpt, "mnist")), _check_mnist),
        ("overlap_audit", 1, "overlap_audit", (), _check_overlap_audit),
        ("longctx_audit", LONGCTX_AUDIT_RANKS, "longctx_audit",
         ("--device", "cuda:0", "--backend", "gloo", "--seq-local",
          str(LONGCTX_AUDIT_SEQ), "--assert-planner"), _check_longctx_audit),
        ("weak_scaling_benchmark", 1, "weak_scaling_benchmark",
         ("--grad-mb", "16"), _check_weak_scaling),
        ("word2vec", 1, "word2vec", ("--steps", "20"), _check_word2vec),
        ("mnist_advanced", 1, "mnist_advanced", (), _check_mnist_advanced),
        ("int8_convergence", 1, "int8_convergence", ("--steps", "40"),
         _check_int8),
        ("control_plane_star", 1, "control_plane_benchmark",
         ("--star", "8,64"), _check_star)]
    timed = [
        ("imagenet_resnet50_resume", 1, "imagenet_resnet50",
         ("--epochs", "2") + r50, _check_imagenet_resume),
        ("collective_microbench", 1, "collective_microbench",
         ("--sizes-mb", "1,16,256"), _check_collectives),
        ("control_plane_benchmark", 1, "control_plane_benchmark", (),
         _check_control_plane),
        ("resnet_bn_experiment", 1, "resnet_bn_experiment",
         ("--batch", "64", "--warmup", "1", "--iters", "2",
          "--batches-per-iter", "2", "--steps-per-call", "1"),
         _check_resnet_bn)]

    def run(spec):
        tag, np_, module, args, check = spec
        lines, seconds[tag] = _example(np_, module, *args)
        out.update(check(lines))

    try:
        with ThreadPoolExecutor(5) as pool:
            list(pool.map(run, checked))
        seconds["checked_stage"] = time.monotonic() - t0
        for spec in timed:
            run(spec)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall_s = time.monotonic() - t0
    emit("examples", wall_s=wall_s, seconds=seconds, **out)
    return {"launches": out["longctx_audit"]["launches"], "wall_s": wall_s}


def phase_analysis() -> None:
    """The analysis tools on the card's host (no device work): the wire
    mirror's golden frames and bulk token against the port's native core
    as built here, the linter over the port's tree, and the model check at
    its default depth."""
    import ctypes

    from horovod_tpu_torch.analysis import lint
    from horovod_tpu_torch.analysis.protocol import wire
    from horovod_tpu_torch.core import check, engine

    t0 = time.monotonic()
    frames = wire.golden_frames()
    drifted = [name for ftype, name, framed in frames
               if engine.frame_golden(ftype) != framed]
    lib = engine.lib()
    lib.hvd_bulk_token.restype = ctypes.c_uint64
    lib.hvd_bulk_token.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int]
    tokens = ((99, 3, 1, 2), (0, 0, 0, 0), (1 << 40, 7, 5, 11))
    if drifted or {t for t, _n, _b in frames} != set(wire.FRAME_NAMES) or \
            any(wire.bulk_token(*a) != lib.hvd_bulk_token(*a)
                for a in tokens):
        raise AssertionError(f"analysis: the wire mirror and the native "
                             f"encoder disagree on {drifted or 'the token'}")
    frames_s = time.monotonic() - t0

    t0 = time.monotonic()
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, p) for p in check.lint_targets()]
    errors = lint.lint_paths(paths)
    if errors:
        raise AssertionError("analysis: lint findings:\n" + "\n".join(
            e.render() for e in errors))
    lint_s = time.monotonic() - t0

    t0 = time.monotonic()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MODELCHECK_")}
    run = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.protocol"],
        capture_output=True, text=True, env=env, cwd=here, timeout=300)
    last = (run.stdout.strip().splitlines() or [""])[-1]
    if run.returncode != 0 or "all invariants hold" not in last:
        raise AssertionError(f"analysis: model check failed "
                             f"(exit {run.returncode}):\n{run.stdout[-3000:]}"
                             f"{run.stderr[-2000:]}")
    modelcheck_s = time.monotonic() - t0
    emit("analysis", frames=len(frames), frames_s=frames_s,
         lint_files=len(lint.iter_py_files(paths)), lint_findings=0,
         lint_s=lint_s, modelcheck_states=int(last.split()[1]),
         modelcheck_s=modelcheck_s, modelcheck=last)


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
    phase_tiles()
    flash = phase_flash()
    dq, dkv = phase_flash_bwd()
    phase_flash_offsets()
    rms = phase_rmsnorm()
    rms_bwd = phase_rmsnorm_bwd()
    decode = phase_decode_attention()
    norm_rows = set()
    with record_norm_rows(norm_rows):
        serve_launches, serve_model, serve_rep = phase_serve()
        if not (serve_launches["flash_fwd"]
                and serve_launches["rmsnorm_fwd"]):
            raise AssertionError("the serve run launched no forward kernel")
        graph_launches = phase_decode_graph()
        paged_launches = phase_serve_paged(serve_model)
        router_launches = phase_router(serve_model)
        del serve_model
        fleet_launches = phase_serve_fleet(serve_rep)
        train = phase_train()
        phase_train_mixed(train)
        phase_train_remat(train)
        phase_train_accumulate()
        eager = phase_train_eager(train)
        longctx = phase_longctx()
    longctx_2proc = phase_longctx_2proc()
    parallel_2proc = phase_parallel_2proc(norm_rows)
    check_norm_rows(norm_rows)
    phase_train_eager_2proc()
    resume = phase_train_resume()
    phase_train_elastic_3proc(resume["deterministic"])
    # Launches on the path: the serve, decode_graph (its graphed run),
    # serve_paged (a-d), router,
    # serve_fleet (every replica's serving run), 162M train and train_eager
    # runs, each counted from 0 around its own run.
    runs = {"serve": serve_launches, "decode_graph": graph_launches,
            "serve_paged": paged_launches,
            "router": router_launches, "serve_fleet": fleet_launches,
            "train": train["launches"], "train_eager": eager["launches"],
            "train_resume": resume["launches"],
            "longctx": longctx["launches"],
            "longctx_2proc": longctx_2proc["launches"],
            "parallel_2proc": parallel_2proc["launches"]}
    phase_resnet()
    runs["cnn"] = phase_cnn()["launches"]
    runs["sync_bn_2proc"] = phase_sync_bn_2proc()["launches"]
    runs["profile"] = phase_profile()["launches"]
    phase_control_plane()
    phase_analysis()
    runs["examples"] = phase_examples()["launches"]
    launches = {k: sum(r.get(k, 0) for r in runs.values())
                for k in serve_launches}
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
             "last-block tickets"),
            ("decode_attention", decode, "none: horovod_tpu/models/"
             "transformer.py:132 is an XLA einsum", cuda_cores,
             "split-KV: a block per (256-position chunk, head group, "
             "slot) streams only the slot's visible K and V, once, "
             "through a 3-stage cp.async ring, with an f32 online "
             "softmax; a second kernel merges the chunks by log-sum-exp "
             "in chunk order; a slot's bits do not depend on B")):
        entries.append({
            "name": name, "route": "cuda", "form": form, "design": design,
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_by_run": {run: r.get(name, 0)
                                for run, r in runs.items()},
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
    if sys.argv[1:2] == ["--eager-worker"]:
        eager_worker(*(int(a) for a in sys.argv[2:5]))
        sys.exit(0)
    if sys.argv[1:2] == ["--resume-worker"]:
        resume_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4] == "1",
                      sys.argv[5] == "1")
        sys.exit(0)
    if sys.argv[1:2] == ["--longctx-worker"]:
        longctx_worker()
        sys.exit(0)
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker()
        sys.exit(0)
    if sys.argv[1:2] == ["--sync-bn-worker"]:
        sync_bn_worker()
        sys.exit(0)
    if sys.argv[1:2] == ["--elastic-worker"]:
        elastic_worker(int(sys.argv[2]), int(sys.argv[3]),
                       int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    sys.exit(main())
