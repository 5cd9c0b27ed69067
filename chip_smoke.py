#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (kernels are built from
``horovod_tpu_torch/csrc`` into ``build/`` at first use).  Phases, one JSON
line each:

1. device    — ``nvidia-smi`` name and power limit (also printed raw on a
               line of its own), torch and CUDA versions;
2. build     — every kernel compiled, one ``nvcc`` per source in parallel;
3. flash     — the flash-attention forward kernel against its plain
               PyTorch version at ``[1, S, 6, 128]`` bf16, with times of
               the kernel, the plain version and
               ``F.scaled_dot_product_attention`` (a yardstick only), and
               the card's bound for the same work;
4. rmsnorm   — the RMSNorm forward kernel against its plain version at
               ``[N, 768]`` bf16, same fields;
5. serve     — the 162M decoder on the card with seeded weights, 16
               requests through ``ServingEngine.submit`` /
               ``run_until_idle``; launch counts of both kernels over that
               run; one prefill repeated through the plain versions;
6. kernels   — ``{"kernels": [...]}``, one entry per kernel of the path.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without that line; it exits non-zero
too when no CUDA device is present or the package is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
FLASH_SHAPES = (  # (S_q, S_k, causal, q_offset): [1, S, 6, 128] bf16
    (128, 128, True, 0), (256, 256, True, 0), (512, 512, True, 0),
    (1000, 1000, True, 0), (1024, 1024, True, 0), (2048, 2048, True, 0),
    (1024, 1024, False, 0), (128, 1024, True, 896))
FLASH_MAIN = (1024, 1024, True, 0)   # the largest prefill bucket
RMS_ROWS = (1, 8, 1000, 2048)        # [N, 768] bf16
RMS_MAIN = 8                         # one decode step over 8 slots
# bf16 outputs: |kernel - plain| <= ATOL + RTOL * |plain|.  Both compute in
# f32 and round once to bf16 (ulp 2**-8 relative), so they differ by at
# most about one ulp; ATOL covers f32 summation order near zero.
BF16_RTOL = 1.6e-2
FLASH_ATOL, RMS_ATOL, LSE_ATOL = 1e-3, 1e-5, 1e-4
# Max |logits(kernels) - logits(plain)| over one 162M prefill.  Logits are
# about N(0, 1) with these weights; the two paths round the same f32 values
# to bf16 after every attention and norm, and a rounding that differs by
# one ulp (2**-8 relative) grows through 12 layers to a few hundredths.
LOGITS_ATOL = 0.125
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

    if sorted(_build.KERNELS) != ["flash_fwd", "rmsnorm_fwd"]:
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
                    if "registers" in ln or "spill" in ln]
             for name, k in _build.KERNELS.items()}
    emit("build", seconds=time.monotonic() - t0, per_kernel_s=per,
         ptxas=ptxas)


def phase_flash() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, d = 6, 128
    worst, main = 0.0, None
    for s_q, s_k, causal, q_off in FLASH_SHAPES:
        q = torch.randn(1, s_q, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(1, s_k, h, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_with_lse(q, k, v, causal, q_off, 0)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                        q_off, 0)
        torch.cuda.synchronize()
        tag = f"flash S_q={s_q} S_k={s_k} causal={causal} q_offset={q_off}"
        err = check_close(tag + " out", out, ref_out, FLASH_ATOL, BF16_RTOL)
        lse_err = check_close(tag + " lse", lse, ref_lse, LSE_ATOL, 0.0)
        worst = max(worst, err, lse_err)
        qpos = q_off + torch.arange(s_q, device="cuda")
        kpos = torch.arange(s_k, device="cuda")
        visible = (qpos[:, None] >= kpos[None, :]) if causal else \
            torch.ones(s_q, s_k, dtype=torch.bool, device="cuda")
        pairs = int(visible.sum())
        flops = 4.0 * h * d * pairs
        nbytes = 2.0 * (2 * s_q + 2 * s_k) * h * d + 4.0 * s_q * h
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = visible if (causal and q_off) else None
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask,
            is_causal=bool(causal and not q_off))
        row = dict(
            shape=[1, s_q, h, d], s_k=s_k, causal=causal, q_offset=q_off,
            max_abs_err=err, lse_max_abs_err=lse_err,
            kernel_ms=time_ms(lambda: fa.flash_attention_with_lse(
                q, k, v, causal, q_off, 0)),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal, q_off, 0)),
            library_ms=time_ms(lib), bound_ms=bound_ms, bound_by=bound_by,
            flops=flops, bytes=nbytes)
        emit("flash", **row)
        if (s_q, s_k, causal, q_off) == FLASH_MAIN:
            main = row
    main["max_abs_err"] = worst
    return main


def phase_rmsnorm() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    e = 768
    scale = 1.0 + 0.1 * torch.randn(e, generator=gen, device="cuda")
    worst, main = 0.0, None
    lib_fn = getattr(F, "rms_norm", None)
    for n in RMS_ROWS:
        x = torch.randn(n, e, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        y = rn.rms_norm(x, scale)
        ref = rn.rms_norm_reference(x, scale)
        torch.cuda.synchronize()
        err = check_close(f"rmsnorm N={n}", y, ref, RMS_ATOL, BF16_RTOL)
        worst = max(worst, err)
        nbytes = 2.0 * n * e * 2 + 4.0 * e
        flops = 4.0 * n * e   # square-accumulate, normalise, scale
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_CUDA_CORE_FLOPS)
        scale_x = scale.to(x.dtype)
        row = dict(
            shape=[n, e], max_abs_err=err,
            kernel_ms=time_ms(lambda: rn.rms_norm(x, scale)),
            plain_ms=time_ms(lambda: rn.rms_norm_reference(x, scale)),
            library_ms=(time_ms(lambda: lib_fn(x, (e,), scale_x, 1e-6))
                        if lib_fn is not None else None),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops,
            bytes=nbytes)
        emit("rmsnorm", **row)
        if n == RMS_MAIN:
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
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
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
    return launches


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
    rms = phase_rmsnorm()
    launches = phase_serve()
    entries = []
    for name, row, replaces in (
            ("flash_fwd", flash,
             "horovod_tpu/ops/flash_attention.py:70"),
            ("rmsnorm_fwd", rms, "horovod_tpu/ops/rmsnorm.py:62")):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(dev["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
