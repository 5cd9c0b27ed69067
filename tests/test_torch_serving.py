"""Port's serving engine against the JAX package's.

The scheduler tests of ``tests/test_serving.py`` run against the port's
copy with the ``StubBackend``; the ``TransformerBackend`` runs the port's
model with the weights of the JAX model (``params_from_flax``), and both
engines must give the same token streams with logits at 2e-5.
"""

import importlib
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtm
from horovod_tpu.serving import engine as jeng
from horovod_tpu.serving import loadgen as jload
from horovod_tpu.serving.worker import expected_completion
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttm
from horovod_tpu_torch.serving import __main__ as tmain
from horovod_tpu_torch.serving import breakdown
from horovod_tpu_torch.serving import engine as teng
from horovod_tpu_torch.serving import loadgen as tload
from horovod_tpu_torch.serving.engine import (ServingConfig, ServingEngine,
                                              StubBackend,
                                              TransformerBackend)
from horovod_tpu_torch.serving.prefix_cache import PrefixCache
from horovod_tpu_torch.utils import env as tenv

jfa = importlib.import_module("horovod_tpu.ops.flash_attention")
tfa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             embed_dim=16, mlp_dim=32, max_seq_len=64)
TOL = dict(atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Scheduler semantics on the StubBackend (the port's copy)
# ---------------------------------------------------------------------------

def _stub_engine(slots=2, **kw):
    return ServingEngine(StubBackend(slots), ServingConfig(
        num_slots=slots, buckets=kw.pop("buckets", (8,)),
        max_seq_len=kw.pop("max_seq_len", 64), **kw))


def test_stub_stream_is_deterministic():
    eng = _stub_engine()
    prompt = [3, 1, 4, 1, 5]
    req = eng.submit(prompt, 6)
    done = eng.run_until_idle()
    assert [r.rid for r in done] == [req.rid]
    assert done[0].tokens == expected_completion(prompt, 6)
    assert done[0].finish_reason == "max_new_tokens"


def test_continuous_admission_backfills_freed_slots():
    eng = _stub_engine()
    for _ in range(2):
        eng.submit([1, 2], 2)
    for _ in range(2):
        eng.submit([3, 4], 8)
    eng.step()
    assert eng.counters["admitted"] == 2 and len(eng.queue) == 2
    eng.step()
    eng.step()
    assert eng.counters["admitted"] == 4
    assert eng.counters["evicted"] >= 2
    eng.run_until_idle()
    assert eng.counters["completed"] == 4


def test_static_batching_holds_admissions_until_drain():
    eng = _stub_engine(static_batching=True)
    for p in ([1], [2], [3]):
        eng.submit(p, 3)
    eng.step()
    assert eng.counters["admitted"] == 2
    eng.step()
    assert eng.counters["admitted"] == 2
    eng.run_until_idle()
    assert eng.counters["completed"] == 3


def test_over_length_evicted_mid_batch():
    eng = _stub_engine(slots=1, max_seq_len=10)
    req = eng.submit([1, 2, 3, 4, 5, 6], 100)
    done = eng.run_until_idle()
    assert done[0].rid == req.rid and done[0].finish_reason == "max_seq_len"
    assert len(done[0].tokens) == 4


def test_unbucketable_prompt_rejected_not_queued():
    eng = _stub_engine(slots=1)
    req = eng.submit(list(range(9)), 4)
    assert req.state == "DONE" and req.finish_reason == "rejected"
    assert not eng.queue and eng.counters["rejected"] == 1
    assert "9 tokens" in req.error and "HVD_TPU_SERVE_BUCKETS" in req.error
    assert "HVD_TPU_SERVE_MAX_LEN" in req.error


def test_eos_finishes_early():
    eng = _stub_engine(slots=1, eos_id=(1 + 2 + 2) % 256)
    req = eng.submit([1, 2], 50)
    done = eng.run_until_idle()
    assert done[0].rid == req.rid and done[0].finish_reason == "eos"
    assert len(done[0].tokens) == 1


def test_serving_stats_accessor(monkeypatch):
    monkeypatch.setattr(teng, "_ACTIVE", None)
    zero = teng.serving_stats()
    assert set(zero) == set(jeng._STATS_KEYS) == set(teng._STATS_KEYS)
    assert all(v == 0 for v in zero.values())
    eng = _stub_engine()
    eng.submit([1, 2, 3], 4)
    eng.run_until_idle()
    live = teng.serving_stats()
    assert live["completed"] == 1 and live["tokens"] == 4
    assert live["steps"] == eng.counters["steps"]


def test_on_complete_sees_every_request():
    seen = []
    eng = ServingEngine(StubBackend(1), ServingConfig(
        num_slots=1, buckets=(8,), max_seq_len=64), on_complete=seen.append)
    reqs = [eng.submit([1, 2, 3], 1), eng.submit([4, 5], 3)]
    eng.run_until_idle()
    assert [r.rid for r in seen] == [r.rid for r in reqs]


def test_spec_decode_reject_path_identical_stream():
    eng = _stub_engine(spec_k=3)
    prompt = [3, 1, 4, 1, 5]
    req = eng.submit(prompt, 8)
    eng.run_until_idle()
    assert req.tokens == expected_completion(prompt, 8)
    st = eng.stats()
    assert st["spec_drafted"] > 0 and st["spec_accepted"] == 0


def test_spec_decode_accept_path_same_tokens_fewer_steps():
    def make(k):
        return ServingEngine(StubBackend(1, period=4), ServingConfig(
            num_slots=1, buckets=(8,), max_seq_len=64, spec_k=k))

    plain, spec = make(0), make(3)
    a = plain.submit([1, 2, 3], 12)
    plain.run_until_idle()
    b = spec.submit([1, 2, 3], 12)
    spec.run_until_idle()
    assert a.tokens == b.tokens
    assert spec.stats()["spec_accepted"] > 0
    assert spec.counters["steps"] < plain.counters["steps"]


def test_prefix_cache_trie_eviction_and_refcount_pinning():
    pc = PrefixCache(num_slots=2, pages_per_slot=4, cache_pages=2,
                     page_size=4)
    hot = list(range(100, 113))
    a0 = pc.admit(0, hot)
    assert a0.prefix_len == 0 and len(a0.donated) == 3
    assert pc.lookup(hot) == 12
    a1 = pc.admit(1, hot, max_prefix_len=pc.lookup(hot))
    assert a1.prefix_len == 12 and a1.shared == a0.donated
    pc.release(1)
    for n in range(8):
        pc.admit(1, [200 + 16 * n + i for i in range(13)])
        pc.release(1)
    assert pc.evictions > 0
    assert pc.lookup(hot) == 12
    pc.release(0)
    for n in range(8):
        pc.admit(0, [600 + 16 * n + i for i in range(13)])
        pc.release(0)
    assert pc.lookup(hot) < 12
    assert pc.resident_pages() + len(pc._free) == pc.num_pages - 1


def test_stub_prefix_cache_same_completions_as_jax_engine():
    # Shared-system-prompt traffic through both engines' admission paths:
    # the same hits, the same completions.
    w = jload.Workload(qps=50.0, duration_s=0.5, seed=3, prompt_lens=(6, 14),
                       shared_frac=0.8, shared_prefix_len=16)
    arrivals = jload.make_arrivals(w)
    assert arrivals == tload.make_arrivals(tload.Workload(**vars(w)))
    out = []
    for mod in (jeng, teng):
        eng = mod.ServingEngine(mod.StubBackend(2), mod.ServingConfig(
            num_slots=2, buckets=(8, 16, 32), max_seq_len=64,
            prefix_cache_pages=8, page_size=8))
        reqs = [eng.submit(p, n) for _, p, n in arrivals]
        eng.run_until_idle()
        st = eng.stats()
        out.append(([r.tokens for r in reqs], st["prefix_hits"],
                     st["prefix_hit_tokens"]))
    assert out[0] == out[1] and out[1][1] > 0


@pytest.mark.parametrize("fn,name,raw", [
    ("serve_slots", "SERVE_SLOTS", "3"), ("serve_slots", "SERVE_SLOTS", "0"),
    ("serve_buckets", "SERVE_BUCKETS", "64,8"),
    ("serve_buckets", "SERVE_BUCKETS", "x"),
    ("serve_max_len", "SERVE_MAX_LEN", "512"),
    ("serve_prefix_pages", "SERVE_PREFIX_PAGES", "4"),
    ("serve_page_tokens", "SERVE_PAGE_TOKENS", "8"),
    ("serve_spec_k", "SERVE_SPEC_K", "2"), ("serve_qps", "SERVE_QPS", "7.5"),
    ("serve_duration_s", "SERVE_DURATION_S", "")])
def test_env_readers_match_jax(monkeypatch, fn, name, raw):
    monkeypatch.setenv("HVD_TPU_" + name, raw)
    results = []
    for mod in (tenv, jenv):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results.append((getattr(mod, fn)(), len(caught)))
    assert results[0] == results[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ServingConfig.from_env() == ServingConfig(
            **vars(jeng.ServingConfig.from_env()))


def test_cli_stub_replica_prints_report(monkeypatch, capsys):
    monkeypatch.setenv("HVD_TPU_SERVE_BACKEND", "stub")
    monkeypatch.setenv("HVD_TPU_SERVE_DURATION_S", "0.2")
    monkeypatch.setenv("HVD_TPU_SERVE_QPS", "40")
    assert tmain.main(["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("SERVE_REPORT ")
    rep = json.loads(line[len("SERVE_REPORT "):])
    assert rep["completed"] == rep["offered"] > 0 and not rep["timed_out"]


# ---------------------------------------------------------------------------
# TransformerBackend: the port's model against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.float32,
                                 attention_fn=jfa.make_flash_attention(),
                                 fused_norm=True)
    tcfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                 attention_fn=tfa.make_flash_attention(),
                                 fused_norm=True)
    jmodel = jtm.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = ttm.Transformer(tcfg, device="cpu")
    state = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tcfg)
    tmodel.load_state_dict(state)
    return jmodel, params, jcfg, tmodel, state


def _port_engine(models, slots, **kw):
    tmodel = models[3]
    return ServingEngine(TransformerBackend(tmodel, slots, 64), ServingConfig(
        num_slots=slots, buckets=(8, 16), max_seq_len=64,
        record_logits=True, **kw))


def _jax_engine(models, slots, **kw):
    jmodel, params, jcfg = models[:3]
    return jeng.ServingEngine(
        jeng.TransformerBackend(jmodel, params, jcfg, slots, max_seq_len=64),
        jeng.ServingConfig(num_slots=slots, buckets=(8, 16), max_seq_len=64,
                           record_logits=True, **kw))


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 64, n))) for n in lens]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_token_streams_and_logits_match_jax_engine(models, spec_k):
    prompts = _prompts(0, (5, 8, 13, 6))
    max_news = [6, 4, 9, 7]
    runs = []
    for make in (_jax_engine, _port_engine):
        eng = make(models, 3, spec_k=spec_k)
        reqs = [eng.submit(p, m) for p, m in zip(prompts[:3], max_news[:3])]
        for _ in range(3):
            eng.step()
        reqs.append(eng.submit(prompts[3], max_news[3]))   # mid-stream
        eng.run_until_idle()
        runs.append(reqs)
    for jr, tr in zip(*runs):
        assert tr.tokens == jr.tokens
        assert len(tr.logits) == len(jr.logits)
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, **TOL)


def test_prefill_logits_match_full_forward(models):
    tmodel = models[3]
    eng = _port_engine(models, 1)
    prompt = [5, 9, 2, 7, 11, 3]
    req = eng.submit(prompt, 1)
    eng.run_until_idle()
    with torch.no_grad():
        full = tmodel(torch.tensor([prompt]))[0, len(prompt) - 1].numpy()
    np.testing.assert_allclose(req.logits[0], full, **TOL)
    assert req.tokens[0] == int(np.argmax(full))


def test_batched_decode_bit_exact_vs_sequential(models):
    # Every request's tokens and per-step logits are bit-identical to
    # decoding it alone through the same-shaped step.
    prompts = _prompts(0, (5, 8, 13, 6))
    max_news = [6, 4, 9, 7]
    eng = _port_engine(models, 3)
    reqs = [eng.submit(p, m) for p, m in zip(prompts[:3], max_news[:3])]
    for _ in range(3):
        eng.step()
    reqs.append(eng.submit(prompts[3], max_news[3]))
    eng.run_until_idle()
    solo_eng = _port_engine(models, 3)
    for req, prompt, max_new in zip(reqs, prompts, max_news):
        solo = solo_eng.submit(prompt, max_new)
        solo_eng.run_until_idle()
        assert solo.tokens == req.tokens
        assert len(solo.logits) == len(req.logits)
        for a, b in zip(solo.logits, req.logits):
            assert np.array_equal(a, b), "logits diverged bitwise"


def test_hot_swap_changes_output(models):
    state = models[4]
    eng = _port_engine(models, 2)
    prompt = [9, 1, 9, 1]
    a = eng.submit(prompt, 5)
    eng.run_until_idle()
    eng.backend.swap_params({k: torch.zeros_like(v)
                             for k, v in state.items()})
    b = eng.submit(prompt, 5)
    eng.run_until_idle()
    eng.backend.swap_params(state)
    c = eng.submit(prompt, 5)
    eng.run_until_idle()
    assert a.tokens == c.tokens and a.tokens != b.tokens


def test_cache_write_past_slot_raises(models):
    backend = TransformerBackend(models[3], 2, 64)
    with pytest.raises(ValueError, match="overflows"):
        backend.verify(np.zeros((2, 3), np.int32), np.array([63, 1]))
    with pytest.raises(ValueError, match="overflows"):
        backend.prefill(np.zeros((1, 128), np.int32), 100, 0)


def test_breakdown_counts_device_time_once_and_by_kind(monkeypatch):
    # Overlapping intervals count once; kernels sort by their names.
    assert breakdown.busy_us([{"ts": 0, "dur": 5}, {"ts": 3, "dur": 4},
                              {"ts": 10, "dur": 1}, {"ts": 1, "dur": 2}]) \
        == 8.0
    assert [breakdown.kind_of(n) for n in (
        "void flash_fwd_kernel<__nv_bfloat16, 128>",
        "void rmsnorm_fwd_kernel<float>", "nvjet_tst_64x8_64x16",
        "sm90_xmma_gemm_bf16bf16", "softmax_warp_forward")] == \
        ["flash_fwd", "rmsnorm_fwd", "matmul", "matmul", "other"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        breakdown.main([])


def test_make_backend_builds_a_seeded_model_on_cpu(monkeypatch):
    cfg = ServingConfig(num_slots=2, buckets=(8,), max_seq_len=32)
    # The 162M config's own shape keeps the kernels on; a small width of it
    # stands in so the CPU builds the backend in a moment.
    full = ttm.config_162m(max_seq_len=32)
    assert (full.num_layers, full.embed_dim, full.vocab_size) == \
        (12, 768, 32000) and full.fused_norm and full.attention_fn
    monkeypatch.setattr(ttm, "config_162m", lambda **kw: ttm.TransformerConfig(
        **{**SMALL, **kw}, dtype=torch.float32))
    a, vocab = tmain.make_backend(cfg, "cpu", seed=1)
    b, _ = tmain.make_backend(cfg, "cpu", seed=1)
    assert vocab == 64 and a.kk.shape == (2, 2, 32, 2, 8)
    for (n, p), (_, q) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(p, q), n
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.make_backend(cfg, None)
