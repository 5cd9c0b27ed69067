"""The serving backends' CUDA graphs of the cache step
(``serving/engine.py`` ``_DecodeGraph``).

On the CPU: a ``TransformerBackend`` on CPU tensors takes the eager path
and replays nothing, a ``PagedTransformerBackend`` never captures, the
dense backend keeps one graph a ``(B, S_q)`` shape (a stand-in for the
graph, which needs a card, records the keys), and ``kv_read_stats()`` and
the engine's ``stats()`` carry the three graph counters.  The
``cuda``-marked tests skip without a card; on one, ``python -m pytest
--noconftest -q tests/test_torch_decode_graph.py`` holds replayed decodes
and verify blocks against the eager cached forward bit for bit, counts the
decode kernel's launches, and swaps the weights under a captured graph.
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as ttm
from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.serving import engine
from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                              ServingConfig, ServingEngine,
                                              TransformerBackend)

GRAPH_KEYS = ("decode_graph_replays", "decode_graph_captures",
              "decode_graph_share")


def _cfg(**kw):
    return ttm.TransformerConfig(**{
        **dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=64,
               embed_dim=32, mlp_dim=64, max_seq_len=128,
               dtype=torch.float32), **kw})


def _model(device="cpu", seed=0, **kw):
    torch.manual_seed(seed)
    return ttm.Transformer(_cfg(**kw), device)


def _serve(backend, slots: int = 3, **kw) -> dict:
    eng = ServingEngine(backend, ServingConfig(
        num_slots=slots, buckets=(8, 16), max_seq_len=64, **kw))
    for n in (3, 7, 11, 5):
        eng.submit(list(range(1, n + 1)), 6)
    eng.run_until_idle()
    return eng.stats()


def _eager_logits(model, kk, vv, tok_block, lengths):
    """The cache step as the model computes it, on ``kk`` / ``vv``."""
    w = np.maximum(np.asarray(lengths, np.int64) - 1, 0)
    dev = kk.device
    with torch.inference_mode():
        logits, _ = model(torch.as_tensor(np.asarray(tok_block, np.int64),
                                          device=dev),
                          kv_cache=(kk, vv),
                          lengths=torch.as_tensor(w, device=dev))
    return logits.float().cpu().numpy()


# -- CPU ---------------------------------------------------------------------

def test_cpu_tensors_take_the_eager_path():
    backend = TransformerBackend(_model(), 3, 64)
    assert backend.graphs is None
    kk, vv = backend.kk.clone(), backend.vv.clone()
    lengths = np.array([1, 9, 30])
    preds, logits = backend.decode(np.array([4, 5, 6]), lengths)
    want = _eager_logits(backend.model, kk, vv, np.array([[4], [5], [6]]),
                         lengths)
    assert np.array_equal(logits, want)
    assert np.array_equal(preds, want.argmax(-1))
    backend.verify(np.ones((3, 5), np.int64), lengths)
    st = backend.kv_read_stats()
    assert backend.cache_steps == 2
    assert (st["decode_graph_replays"], st["decode_graph_captures"],
            st["decode_graph_share"]) == (0, 0, 0.0)


def test_paged_backend_never_captures(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the paged backend built a CUDA graph")

    monkeypatch.setattr(engine, "_DecodeGraph", refuse)
    backend = PagedTransformerBackend(_model(), 3, 64, cache_pages=8,
                                      page_size=8)
    assert not hasattr(backend, "graphs")
    st = _serve(backend, spec_k=2)
    assert st["steps"] > 0 and backend.cache_steps > 0
    assert (st["decode_graph_replays"], st["decode_graph_captures"],
            st["decode_graph_share"]) == (0, 0, 0.0)


class _RecordingGraph:
    """Stands in for ``_DecodeGraph`` where there is no card: runs the
    step eagerly, and counts as the graph does (an eager first call, a
    capture on the second, a replay on the second and every later one)."""

    made: list = []

    def __init__(self, b, s_q, device):
        self.key, self.calls, self.replays, self.graph = (b, s_q), 0, 0, None
        _RecordingGraph.made.append(self.key)

    def __call__(self, step, tok_block, w):
        assert tok_block.shape == self.key and w.shape == (self.key[0],)
        self.calls += 1
        if self.calls == 2:
            self.graph = "captured"
        self.replays += self.calls > 1
        return step(torch.as_tensor(tok_block.astype(np.int64)),
                    torch.as_tensor(w))


def test_one_graph_a_batch_and_block_width(monkeypatch):
    _RecordingGraph.made = []
    monkeypatch.setattr(engine, "_DecodeGraph", _RecordingGraph)
    backend = TransformerBackend(_model(), 3, 64)
    backend.graphs = {}                      # as on a card
    plain = TransformerBackend(_model(), 3, 64)
    lengths = np.array([1, 9, 30])
    calls = [("decode", np.array([4, 5, 6])),
             ("verify", np.ones((3, 5), np.int64)),
             ("decode", np.array([7, 8, 9])),
             ("verify", np.full((3, 3), 2, np.int64)),
             ("decode", np.array([1, 2, 3])),
             ("verify", np.zeros((3, 5), np.int64))]
    for i, (kind, block) in enumerate(calls):
        got = getattr(backend, kind)(block, lengths + i)
        want = getattr(plain, kind)(block, lengths + i)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert _RecordingGraph.made == [(3, 1), (3, 5), (3, 3)]
    assert sorted(backend.graphs) == [(3, 1), (3, 3), (3, 5)]
    st = backend.kv_read_stats()
    # (3, 1): eager, replay, replay; (3, 5): eager, replay; (3, 3): eager.
    assert st["decode_graph_replays"] == 3
    assert st["decode_graph_captures"] == 2
    assert st["decode_graph_share"] == 3 / 6


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_stats_carry_the_graph_counters(kind):
    backend = TransformerBackend(_model(), 3, 64) if kind == "dense" else \
        PagedTransformerBackend(_model(), 3, 64, cache_pages=8, page_size=8)
    before = backend.kv_read_stats()
    assert set(GRAPH_KEYS) <= set(before)
    assert before["decode_graph_share"] == 0.0
    st = _serve(backend)
    assert set(GRAPH_KEYS) <= set(st)
    assert isinstance(st["decode_graph_replays"], int)
    assert isinstance(st["decode_graph_captures"], int)
    assert isinstance(st["decode_graph_share"], float)


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_cfg():
    return dict(num_layers=3, num_heads=4, embed_dim=256, mlp_dim=512,
                max_seq_len=512, dtype=torch.bfloat16, fused_norm=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s_q", [1, 5])
def test_replay_is_the_eager_cached_forward_bit_for_bit(cuda, s_q):
    backend = TransformerBackend(_model(cuda, **_card_cfg()), 4, 512)
    rng = np.random.default_rng(s_q)
    lengths = np.array([1, 40, 300, 2])
    for step in range(6):
        block = rng.integers(0, 64, (4, s_q))
        kk, vv = backend.kk.clone(), backend.vv.clone()
        before = da.KERNEL.launches
        preds, logits = backend.verify(block, lengths)
        assert da.KERNEL.launches - before == 3, step
        want = _eager_logits(backend.model, kk, vv, block, lengths)
        assert np.array_equal(logits, want), step
        assert np.array_equal(preds, want.argmax(-1)), step
        # The cache each wrote is the same too.
        assert torch.equal(backend.kk, kk) and torch.equal(backend.vv, vv)
        lengths = lengths + s_q
    st = backend.kv_read_stats()
    assert (st["decode_graph_replays"], st["decode_graph_captures"]) == (5, 1)


@pytest.mark.cuda
def test_replay_after_swap_params_reads_the_new_weights(cuda):
    backend = TransformerBackend(_model(cuda, **_card_cfg()), 4, 512)
    other = _model(cuda, seed=1, **_card_cfg())
    lengths = np.array([1, 2, 3, 4])
    for _ in range(3):                       # eager, capture, replay
        backend.decode(np.array([1, 2, 3, 4]), lengths)
    backend.swap_params(other.state_dict())
    kk, vv = backend.kk.clone(), backend.vv.clone()
    _, logits = backend.decode(np.array([5, 6, 7, 8]), lengths)
    assert backend.kv_read_stats()["decode_graph_replays"] == 3
    assert np.array_equal(logits, _eager_logits(
        other, kk, vv, np.array([[5], [6], [7], [8]]), lengths))
