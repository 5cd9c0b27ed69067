"""Continuous-batching decode engine — counterpart of
``horovod_tpu/serving/engine.py``.

The scheduler packs active sequences into a fixed number of KV-cache
*slots* and runs one decode step over all slots per tick.  New requests
are admitted into freed slots every step (prefill is bucketed to a fixed
length menu) and finished or over-length sequences are evicted mid-batch —
no drain barriers.  The scheduler is the JAX package's, kept line for line
so both engines make the same decisions on the same traffic; what differs
is the model backend.

Backends:

* :class:`TransformerBackend` runs the PyTorch :class:`Transformer` on its
  KV-cache path: a prefill per admission (``return_kv=True``, the model's
  flash-attention and RMSNorm kernels on the card) and one decode step
  over all slots.  Every backend op is batch-row-independent, so a
  sequence's logits in a mixed batch equal the same sequence decoded
  alone through the same-shaped step.
* :class:`PagedTransformerBackend` reads K/V through per-slot page tables
  over a page pool, which lets admissions attach to shared prompt-prefix
  pages (``prefix_cache.py``) and prefill only their suffix.
* :class:`StubBackend` is the numpy token automaton of the JAX package.

Shared-prefix reuse (any paged backend, or ``prefix_cache_pages`` on the
stub) and greedy speculative decoding (``ServingConfig.spec_k``) compose
on top as in the JAX package.  With ``collective=`` (a
:class:`~horovod_tpu_torch.core.engine.NativeEngine`) every step ends in
the fleet tick, as in the JAX package: one fixed-name, fixed-shape
allreduce of the replica's counters, which keeps the control plane's
response cache warm, holds the replicas in step and gives each the fleet
aggregate its autoscaler reads; admissions, rejections, prefix hits,
accepted drafts and evictions land as ``SERVING_*`` instants on the
engine's timeline.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from horovod_tpu_torch.ops import _build, decode_attention
from horovod_tpu_torch.serving.prefix_cache import PrefixCache
from horovod_tpu_torch.utils import profiling

_ACTIVE = None  # most recently constructed ServingEngine, for serving_stats()

_STATS_KEYS = (
    "active_slots", "queue_depth", "admitted", "evicted", "completed",
    "rejected", "retried", "steps", "tokens", "ttft_p50_ms", "ttft_p99_ms",
    "token_p50_ms", "token_p99_ms", "kv_slot_occupancy",
    "prefix_hits", "prefix_hit_tokens", "prefix_evictions",
    "prefix_hit_rate", "spec_drafted", "spec_accepted", "spec_accept_rate",
)

_FLOAT_STATS = frozenset((
    "ttft_p50_ms", "ttft_p99_ms", "token_p50_ms", "token_p99_ms",
    "kv_slot_occupancy", "prefix_hit_rate", "spec_accept_rate",
))


def _pctile(xs, q: float) -> float:
    """Nearest-rank percentile; 0.0 on empty (the loadgen's too)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))])


@dataclasses.dataclass
class Request:
    """One serving request as it moves QUEUED → ACTIVE → DONE.

    ``finish_reason`` is one of ``"eos"``, ``"max_new_tokens"``,
    ``"max_seq_len"`` or ``"rejected"``.  Timing fields are engine-clock
    seconds; ``logits`` is filled only under
    ``ServingConfig.record_logits``."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    submitted_t: float = 0.0
    state: str = "QUEUED"
    slot: int = -1
    tokens: list[int] = dataclasses.field(default_factory=list)
    logits: list[Any] = dataclasses.field(default_factory=list)
    finish_reason: str | None = None
    error: str | None = None
    ttft_s: float | None = None
    token_lat_s: list[float] = dataclasses.field(default_factory=list)
    _last_token_t: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Scheduler knobs; :func:`from_env` reads the ``HVD_TPU_SERVE_*``
    table (``utils/env.py``)."""

    num_slots: int = 8
    # Prefill length menu, ascending: a prompt prefills at the smallest
    # bucket that holds it.
    buckets: tuple[int, ...] = (16, 32, 64, 128)
    max_seq_len: int = 256
    eos_id: int | None = None
    # Admit only into a fully drained batch (the static-batching barrier).
    static_batching: bool = False
    # Keep per-step logits on each request (tests only — unbounded).
    record_logits: bool = False
    # Shared-prefix reuse: pages of slack beyond the slots' own working
    # set; 0 disables it for the stub (a paged backend brings its own
    # pool and always runs with the cache on).
    prefix_cache_pages: int = 0
    page_size: int = 16
    # Speculative decoding draft window; 0 disables speculation.
    spec_k: int = 0
    spec_ngram: int = 2

    @staticmethod
    def from_env(**overrides) -> "ServingConfig":
        from horovod_tpu_torch.utils import env

        base = dict(num_slots=env.serve_slots(), buckets=env.serve_buckets(),
                    max_seq_len=env.serve_max_len(),
                    prefix_cache_pages=env.serve_prefix_pages(),
                    page_size=env.serve_page_tokens(),
                    spec_k=env.serve_spec_k())
        base.update(overrides)
        return ServingConfig(**base)


class StubBackend:
    """Deterministic token automaton — no model, no device.

    The next token is a pure function of (previous token, position), or
    ``(prev + 1) % period`` with ``period`` set (a stream the n-gram
    proposer can predict).  ``step_s`` and ``prefill_s_per_token`` add
    synthetic compute time."""

    def __init__(self, num_slots: int, vocab_size: int = 256,
                 step_s: float = 0.0, period: int | None = None,
                 prefill_s_per_token: float = 0.0):
        self.num_slots = num_slots
        self.vocab_size = vocab_size
        self.step_s = step_s
        self.period = period
        self.prefill_s_per_token = prefill_s_per_token

    @staticmethod
    def _next(prev: int, pos: int, vocab: int) -> int:
        return (prev * 31 + pos * 7 + 1) % vocab

    def _next_tok(self, prev: int, pos: int) -> int:
        if self.period is not None:
            return (int(prev) + 1) % self.period
        return self._next(int(prev), int(pos), self.vocab_size)

    def prefill(self, padded: np.ndarray, length: int, slot: int):
        if self.prefill_s_per_token:
            time.sleep(self.prefill_s_per_token * length)
        first = (int(np.sum(padded[0, :length])) + length) % self.vocab_size
        logits = np.zeros(self.vocab_size, np.float32)
        logits[first] = 1.0
        return first, logits

    def prefill_prefixed(self, padded: np.ndarray, suffix_len: int,
                         slot: int, prefix_len: int, prompt=None):
        """Prefix-attached prefill: only the suffix pays compute, and the
        first token is still a function of the full prompt."""
        if self.prefill_s_per_token:
            time.sleep(self.prefill_s_per_token * suffix_len)
        full = list(prompt) if prompt is not None else \
            list(padded[0, :suffix_len])
        first = (int(sum(int(t) for t in full)) + len(full)) % self.vocab_size
        logits = np.zeros(self.vocab_size, np.float32)
        logits[first] = 1.0
        return first, logits

    def decode(self, last_tokens: np.ndarray, lengths: np.ndarray):
        if self.step_s:
            time.sleep(self.step_s)
        nxt = np.array([self._next_tok(int(t), int(p))
                        for t, p in zip(last_tokens, lengths)], np.int32)
        logits = np.zeros((self.num_slots, self.vocab_size), np.float32)
        logits[np.arange(self.num_slots), nxt] = 1.0
        return nxt, logits

    def verify(self, tok_block: np.ndarray, lengths: np.ndarray):
        """``preds[b, j]``: the token the automaton emits after column
        ``j`` at position ``lengths[b] + j``; column 0 is :meth:`decode`."""
        if self.step_s:
            time.sleep(self.step_s)
        b_n, k1 = tok_block.shape
        preds = np.zeros((b_n, k1), np.int32)
        for b in range(b_n):
            for j in range(k1):
                preds[b, j] = self._next_tok(int(tok_block[b, j]),
                                             int(lengths[b]) + j)
        logits = np.zeros((b_n, k1, self.vocab_size), np.float32)
        np.put_along_axis(logits, preds[:, :, None], 1.0, axis=2)
        return preds, logits


class _ModelBackend:
    """What the two model backends share: the model, host-to-device token
    transfer, the host-side bounds check of every cache write, greedy
    decode and verify over :meth:`_cache_step`, and the weight hot-swap.

    ``jax.lax.dynamic_update_slice`` clamps a start that would overflow the
    cache; a tensor write does not, so every step checks on the host that
    its block fits and raises otherwise (the engine never asks for one that
    does not: it evicts a sequence at ``max_seq_len`` and speculates only
    with room).

    Each cache step adds to two host counters: the cache positions its
    attention reads, ``Σ (w[b] + S_q)`` over the slots, and the positions a
    read of every slot's whole cache would take, ``B × max_seq_len``;
    :meth:`kv_read_stats` reports their ratio beside the decode kernel's
    launches and the cache steps that replayed a CUDA graph."""

    def __init__(self, model, num_slots: int, max_seq_len: int):
        self.model = model
        self.num_slots, self.max_seq_len = num_slots, max_seq_len
        self.device = next(model.parameters()).device
        self.kv_positions_read = self.kv_positions_dense = 0
        self.cache_steps = 0

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _check_fits(self, start: int, block: int) -> None:
        if start < 0 or start + block > self.max_seq_len:
            raise ValueError(
                f"KV write of {block} positions at {start} overflows the "
                f"{self.max_seq_len}-position slot")

    def _cache_step(self, tok_block: np.ndarray, lengths: np.ndarray):
        # The engine's lengths count the pending (not yet cached) token;
        # the model wants the incoming token's position = cache fill
        # count = lengths - 1.
        with profiling.span("serve.decode"):
            w = np.maximum(np.asarray(lengths, np.int64) - 1, 0)
            s_q = tok_block.shape[1]
            self._check_fits(int(w.max()), s_q)
            self.kv_positions_read += int(w.sum()) + w.size * s_q
            self.kv_positions_dense += w.size * self.max_seq_len
            self.cache_steps += 1
            with torch.inference_mode():
                logits = self._run_cached(np.asarray(tok_block), w)
                with profiling.span("serve.to_host"):
                    preds = torch.argmax(logits, dim=-1).to(torch.int32)
                    return preds.cpu().numpy(), logits.float().cpu().numpy()

    def _graph_counts(self) -> tuple[int, int]:
        """Replays and captures of CUDA graphs among the cache steps; a
        backend that captures none has none."""
        return 0, 0

    def kv_read_stats(self) -> dict:
        """``kv_read_share``: the cache positions the cache steps read over
        those a dense read takes (0.0 before the first step);
        ``decode_attention_launches``: the decode kernel's launch count
        in this process; ``decode_graph_replays`` and
        ``decode_graph_captures``: the cache steps that replayed a CUDA
        graph and the graphs captured, and ``decode_graph_share`` the
        replays over the cache steps (0.0 before the first)."""
        replays, captures = self._graph_counts()
        return {"kv_read_share": (self.kv_positions_read
                                  / max(self.kv_positions_dense, 1)),
                "decode_attention_launches": decode_attention.KERNEL.launches,
                "decode_graph_replays": replays,
                "decode_graph_captures": captures,
                "decode_graph_share": replays / max(self.cache_steps, 1)}

    def decode(self, last_tokens: np.ndarray, lengths: np.ndarray):
        return self._cache_step(np.asarray(last_tokens)[:, None], lengths)

    def verify(self, tok_block: np.ndarray, lengths: np.ndarray):
        """One cache step over the ``[B, k+1]`` block: row ``j``'s logits
        depend only on the cache and block rows ``<= j``, so column 0 is
        plain decode's output.  K/V of rejected rows land past the
        accepted length, masked until the next block overwrites them."""
        return self._cache_step(np.asarray(tok_block), lengths)

    def swap_params(self, state_dict) -> None:
        """Hot-swap the weights in place; in-flight sequences keep their
        KV cache."""
        self.model.load_state_dict(state_dict)


class _DecodeGraph:
    """One shape ``(B, S_q)`` of :class:`TransformerBackend`'s cache step
    as a CUDA graph.

    ``step(tokens, w)``, passed to each call, is the model's cache step on
    the backend's static cache.  Its inputs live in one static device
    tensor, the ``[B, S_q]`` token block then the ``[B]`` write positions,
    which every call fills from a pinned staging copy by one asynchronous
    copy.  The first call runs ``step`` eagerly on a side stream: it warms
    cuBLAS and builds every kernel the port loads lazily.  The second
    captures it there, in a private pool, then replays the graph; every
    later call replays it.  The cache is written in place and the decode
    kernel reads the lengths on the device, so one graph serves every mix
    of slot lengths, and the parameters are read where ``load_state_dict``
    copies new weights.

    The port's launch counters stay counts of launches on the card: the
    launches a capture counted are taken back, and added again at every
    replay.  A capture that fails raises."""

    def __init__(self, b: int, s_q: int, device):
        n = b * s_q
        self.staged = torch.empty(n + b, dtype=torch.int64, pin_memory=True)
        self.host = self.staged.numpy()
        self.inputs = torch.empty(n + b, dtype=torch.int64, device=device)
        self.tokens, self.w = self.inputs[:n].view(b, s_q), self.inputs[n:]
        self.copied = torch.cuda.Event()
        self.stream = torch.cuda.Stream(device)
        self.graph = self.logits = None
        self.warm = False
        self.replays = 0
        self.launches: list = []       # (kernel, launches a replay)

    def __call__(self, step, tok_block: np.ndarray, w: np.ndarray):
        self.copied.synchronize()      # the last copy out of ``staged`` ran
        self.host[:tok_block.size] = tok_block.reshape(-1)
        self.host[tok_block.size:] = w
        self.inputs.copy_(self.staged, non_blocking=True)
        self.copied.record()
        if self.graph is None:
            if not self.warm:
                return self._eager(step)
            self._capture(step)
        with profiling.span("serve.decode_graph"):
            self.graph.replay()
        self.replays += 1
        for kernel, n in self.launches:
            kernel.launches += n
        return self.logits

    def _eager(self, step):
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            logits = step(self.tokens, self.w)
        current.wait_stream(self.stream)
        logits.record_stream(current)
        self.warm = True
        return logits

    def _capture(self, step) -> None:
        kernels = list(_build.KERNELS.values())
        before = [k.launches for k in kernels]
        graph = torch.cuda.CUDAGraph()
        # Thread-local: another thread of the process (a fleet's control
        # plane) may call CUDA while this one captures.
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            logits = step(self.tokens, self.w)
        self.launches = [(k, k.launches - n)
                         for k, n in zip(kernels, before) if k.launches > n]
        for kernel, n in self.launches:
            kernel.launches -= n
        self.graph, self.logits = graph, logits


class TransformerBackend(_ModelBackend):
    """The PyTorch :class:`Transformer` on its KV-cache path.

    The per-slot cache is two ``[L, slots, max_seq_len, H, D]`` tensors on
    the model's device, allocated once.  A prefill runs the full forward
    over the admitted prompt's bucket with ``return_kv=True`` and copies
    its K/V into the slot; a decode runs one cache step over every slot,
    whatever the active set is (inactive slots decode garbage at position
    0, which the engine ignores and the next prefill overwrites).  Sampling
    is greedy.  Everything runs under ``torch.inference_mode``: the
    kernels have no backward yet.  The cache is written in place.

    On a CUDA device the cache steps replay CUDA graphs, one a ``(B,
    S_q)`` shape (:class:`_DecodeGraph`: decode, and each verify block's
    width), inside a ``serve.decode_graph`` span; on the CPU they run
    eagerly.  Prefills run eagerly everywhere.
    """

    def __init__(self, model, num_slots: int, max_seq_len: int):
        from horovod_tpu_torch.models.transformer import init_kv_cache

        super().__init__(model, num_slots, max_seq_len)
        self.kk, self.vv = init_kv_cache(model.cfg, num_slots, max_seq_len,
                                         device=self.device)
        self.graphs: dict[tuple[int, int], _DecodeGraph] | None = \
            {} if self.device.type == "cuda" else None

    def prefill(self, padded: np.ndarray, length: int, slot: int):
        with profiling.span("serve.prefill"):
            self._check_fits(0, padded.shape[1])
            with torch.inference_mode():
                logits, (pk, pv) = self.model(self._tokens(padded),
                                              return_kv=True)
                s = padded.shape[1]
                self.kk[:, slot, :s] = pk[:, 0]
                self.vv[:, slot, :s] = pv[:, 0]
                last = logits[0, length - 1]
                with profiling.span("serve.to_host"):
                    first = int(torch.argmax(last))
                    return first, last.float().cpu().numpy()

    def _step(self, tokens: torch.Tensor, w: torch.Tensor):
        logits, _ = self.model(tokens, kv_cache=(self.kk, self.vv),
                               lengths=w)
        return logits

    def _run_cached(self, tok_block: np.ndarray, w: np.ndarray):
        if self.graphs is None:
            return self._step(self._tokens(tok_block), self._tokens(w))
        graph = self.graphs.get(tok_block.shape)
        if graph is None:
            graph = self.graphs[tok_block.shape] = _DecodeGraph(
                *tok_block.shape, self.device)
        return graph(self._step, tok_block, w)

    def _graph_counts(self) -> tuple[int, int]:
        graphs = (self.graphs or {}).values()
        return (sum(g.replays for g in graphs),
                sum(g.graph is not None for g in graphs))


class PagedTransformerBackend(_ModelBackend):
    """:class:`TransformerBackend` reading K/V through per-slot page tables.

    The pool is two ``[L, pages, page_size, H, D]`` tensors
    (:func:`~horovod_tpu_torch.models.transformer.init_kv_pages`) and a
    slot is a row of page ids, so a page holding a shared prompt-prefix
    chunk can appear in many slots' rows at once.  Every call gathers the
    rows it runs into the dense ``[L, B, S, H, D]`` layout of
    :class:`TransformerBackend`, runs the same model code on its cache path
    (which writes the block in place), then scatters the written positions
    back into their pages: paging changes memory layout, never arithmetic.
    Only the written positions go back, so no admission writes a shared
    prefix page (the JAX package scatters the whole row, its shared pages
    with the values they already hold).

    Every prefill, cold or prefix-attached, enters through the cache path
    at position ``prefix_len``, as in the JAX package: the causal mask
    exposes the cached prefix pages plus earlier block rows, the context a
    cold full-prompt prefill gives each position.  So the paged path never
    runs the flash kernel: its decode and verify calls run the decode
    attention kernel on the gathered view, its prefills of a bucket's
    length the plain cache attention, all of them the RMSNorm kernel.

    Shapes are fixed: the page tables are one ``[slots, pages_per_slot]``
    tensor on the pool's device, updated in place by :meth:`attach_slot`
    and :meth:`release_slot` (a detached row points at the scratch page
    0), and the gather and scatter indices are computed on the device from
    ``lengths``, so decode and verify each have one shape whatever the mix
    of admissions.  The gather and scatter run inside profiler spans
    ``paged_gather`` and ``paged_scatter`` (``utils/profiling.span``),
    which the breakdown reads.  Page-id bookkeeping (allocation,
    refcounts, trie) is
    :class:`~horovod_tpu_torch.serving.prefix_cache.PrefixCache`'s; the
    engine feeds admissions' page rows in through :meth:`attach_slot`.
    """

    paged = True

    def __init__(self, model, num_slots: int, max_seq_len: int,
                 cache_pages: int = 0, page_size: int = 16):
        from horovod_tpu_torch.models.transformer import init_kv_pages

        if max_seq_len % page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        super().__init__(model, num_slots, max_seq_len)
        self.page_size = page_size
        self.pages_per_slot = max_seq_len // page_size
        self.cache_pages = cache_pages
        num_pages = 1 + num_slots * self.pages_per_slot + cache_pages
        self.pk, self.pv = init_kv_pages(model.cfg, num_pages, page_size,
                                         device=self.device)
        # Row s: the pages slot s reads and writes, in sequence order.
        self.page_tables = torch.zeros((num_slots, self.pages_per_slot),
                                       dtype=torch.int64, device=self.device)

    # -- page-table plumbing ------------------------------------------

    def attach_slot(self, slot: int, page_row) -> None:
        self.page_tables[slot] = self._tokens(page_row)

    def release_slot(self, slot: int) -> None:
        self.page_tables[slot] = 0

    def _gather(self, tables: torch.Tensor):
        """Pages -> dense ``[L, B, S, H, D]`` copies for the model's cache
        path: exactly what a dense per-slot cache would hold."""
        if tables.device != self.pk.device:
            raise RuntimeError(f"page tables on {tables.device} cannot "
                               f"index a pool on {self.pk.device}")
        ell, _, ps, h, d = self.pk.shape
        b, p = tables.shape
        with profiling.span("paged_gather"):
            idx = tables.reshape(-1)
            return (self.pk.index_select(1, idx).view(ell, b, p * ps, h, d),
                    self.pv.index_select(1, idx).view(ell, b, p * ps, h, d))

    def _scatter(self, tables, kd, vd, start, n: int) -> None:
        """Positions ``start[b] .. start[b] + n`` of each dense row back
        into their pages."""
        with profiling.span("paged_scatter"):
            offs = start[:, None] + torch.arange(n, device=start.device)
            rows = torch.arange(tables.shape[0], device=start.device)[:, None]
            pidx = tables.gather(1, offs // self.page_size)
            poff = offs % self.page_size
            self.pk[:, pidx, poff] = kd[:, rows, offs]
            self.pv[:, pidx, poff] = vd[:, rows, offs]

    def _run(self, tables, tokens, start):
        kd, vd = self._gather(tables)
        logits, _ = self.model(tokens, kv_cache=(kd, vd), lengths=start)
        self._scatter(tables, kd, vd, start, tokens.shape[1])
        return logits

    def _run_cached(self, tok_block: np.ndarray, w: np.ndarray):
        return self._run(self.page_tables, self._tokens(tok_block),
                         self._tokens(w))

    # -- backend interface --------------------------------------------

    def prefill(self, padded: np.ndarray, length: int, slot: int):
        return self.prefill_prefixed(padded, length, slot, 0)

    def prefill_prefixed(self, padded: np.ndarray, suffix_len: int,
                         slot: int, prefix_len: int, prompt=None):
        """Prefill the suffix block at position ``prefix_len`` of the
        slot's row, whose first ``prefix_len // page_size`` pages already
        hold the prefix's K/V."""
        with profiling.span("serve.prefill"):
            self._check_fits(prefix_len, padded.shape[1])
            with torch.inference_mode():
                logits = self._run(self.page_tables[slot:slot + 1],
                                   self._tokens(padded),
                                   self._tokens([prefix_len]))
                last = logits[0] if padded.shape[1] == 1 else \
                    logits[0, suffix_len - 1]
                with profiling.span("serve.to_host"):
                    first = int(torch.argmax(last))
                    return first, last.float().cpu().numpy()


class ServingEngine:
    """The continuous-batching scheduler.

    Each :meth:`step` (i) admits queued requests into free slots —
    prefill produces the first token, so TTFT is measured here — then
    (ii) runs one decode over all slots and (iii) evicts finished or
    over-length sequences, freeing their slots for the next tick.

    With ``collective=`` each step ends in :meth:`_tick_collective`: one
    allreduce named ``tick_name`` (default :attr:`TICK_NAME`; distinct per
    model when several engines share one control plane, as the router's
    do) of a fixed 9-float vector.  Completions are delivered before it:
    a membership change raises :class:`MembershipChanged` out of the tick,
    and the step's completions are then parked in ``_undelivered`` and
    handed over by the next step.  :meth:`tick_stats` gives the tick's
    host time."""

    TICK_NAME = "serving.tick"
    DRAINED_NAME = "serving.drained"

    def __init__(self, backend, config: ServingConfig | None = None,
                 collective=None, clock: Callable[[], float] = time.monotonic,
                 on_complete: Callable[[Request], None] | None = None,
                 tick_name: str | None = None):
        global _ACTIVE
        self.backend = backend
        self.config = config or ServingConfig()
        self.collective = collective
        self.clock = clock
        self.on_complete = on_complete
        self.tick_name = tick_name or self.TICK_NAME
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.config.num_slots
        self.last_tokens = np.zeros(self.config.num_slots, np.int32)
        self.lengths = np.zeros(self.config.num_slots, np.int32)
        cfg = self.config
        # A paged backend brings its own pool dimensions; the stub opts in
        # through prefix_cache_pages (its pages are notional).
        self.prefix: PrefixCache | None = None
        if getattr(backend, "paged", False):
            self.prefix = PrefixCache(cfg.num_slots, backend.pages_per_slot,
                                      backend.cache_pages, backend.page_size)
        elif cfg.prefix_cache_pages > 0 and \
                hasattr(backend, "prefill_prefixed"):
            if cfg.max_seq_len % cfg.page_size:
                raise ValueError(
                    "max_seq_len must be a multiple of page_size when the "
                    "prefix cache is enabled")
            self.prefix = PrefixCache(cfg.num_slots,
                                      cfg.max_seq_len // cfg.page_size,
                                      cfg.prefix_cache_pages, cfg.page_size)
        self.counters = dict.fromkeys(
            ("admitted", "evicted", "completed", "rejected", "retried",
             "steps", "tokens", "prompt_tokens", "prefix_hits",
             "prefix_hit_tokens", "spec_drafted", "spec_accepted"), 0)
        self._ttft_s: list[float] = []
        self._token_s: list[float] = []
        self._tick_s: list[float] = []
        self._rid = itertools.count()
        self.fleet: dict[str, float] = {}
        # Set by drivers whose request stream is exhausted; rides the tick
        # vector.  A replica keeps ticking until every replica has drained:
        # one that stopped early would stall the others' tick.
        self.done_flag = 0.0
        # Completions of a step whose tick raised MembershipChanged,
        # handed to the caller by the next successful step.
        self._undelivered: list[Request] = []
        _ACTIVE = self

    # -- request intake ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, rid: int | None = None,
               retry: bool = False) -> Request:
        req = Request(rid=next(self._rid) if rid is None else rid,
                      prompt=list(prompt), max_new_tokens=max_new_tokens,
                      submitted_t=self.clock())
        if retry:
            self.counters["retried"] += 1
        if len(req.prompt) > max(self.config.buckets) or \
                len(req.prompt) >= self.config.max_seq_len:
            req.state, req.finish_reason = "DONE", "rejected"
            req.error = (
                f"prompt of {len(req.prompt)} tokens exceeds the largest "
                f"prefill bucket ({max(self.config.buckets)}; extend the "
                f"ladder with HVD_TPU_SERVE_BUCKETS) or the KV slot size "
                f"(max_seq_len={self.config.max_seq_len}; raise with "
                f"HVD_TPU_SERVE_MAX_LEN)")
            self.counters["rejected"] += 1
            if self.collective is not None:
                self.collective.timeline_instant(
                    "SERVING_REJECT",
                    f"req={req.rid} len={len(req.prompt)} "
                    f"max_bucket={max(self.config.buckets)} "
                    f"max_seq_len={self.config.max_seq_len}")
            return req
        self.queue.append(req)
        return req

    def _bucket(self, n: int) -> int:
        for b in self.config.buckets:
            if b >= n:
                return b
        raise AssertionError("unbucketable prompt slipped past submit()")

    # -- the tick ---------------------------------------------------------

    def step(self) -> list[Request]:
        with profiling.span("serve.step"):
            return self._step()

    def _step(self) -> list[Request]:
        done: list[Request] = []
        self._admit(done)
        if any(r is not None for r in self.slots):
            if self._spec_ready():
                self._spec_step(done)
            else:
                nxt, logits = self.backend.decode(self.last_tokens,
                                                  self.lengths)
                now = self.clock()
                for s, req in enumerate(self.slots):
                    if req is None:
                        continue
                    self._take_token(req, s, int(nxt[s]), logits[s], now)
                    if req.state == "DONE":
                        self._evict(req, s, done)
        self.counters["steps"] += 1
        # Deliver completions BEFORE the tick: enqueue / synchronize raise
        # MembershipChanged on a reconfiguration, and a request already
        # evicted from its slot but not yet reported would otherwise be a
        # lost response.
        if self.on_complete:
            for req in done:
                self.on_complete(req)
        done = self._undelivered + done
        self._undelivered = []
        try:
            self._tick_collective()
        except BaseException:
            # Aborted tick: the caller never sees this step's return
            # value, so park the completions for the next step.
            self._undelivered = done
            raise
        return done

    def _admit(self, done: list[Request]) -> None:
        cfg = self.config
        if cfg.static_batching and any(r is not None for r in self.slots):
            return  # the drain barrier continuous batching removes
        for s in range(cfg.num_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            hit = 0
            if self.prefix is not None:
                hit = self.prefix.lookup(req.prompt)
                # Shrink the hit until the suffix bucket's block fits the
                # slot's sequence range.
                while hit and hit + self._bucket(len(req.prompt) - hit) \
                        > cfg.max_seq_len:
                    hit -= self.prefix.page_size
                adm = self.prefix.admit(s, req.prompt, max_prefix_len=hit)
                hit = adm.prefix_len
                if getattr(self.backend, "paged", False):
                    self.backend.attach_slot(s, adm.page_row)
            suffix = req.prompt[hit:]
            bucket = self._bucket(len(suffix))
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(suffix)] = suffix
            if self.prefix is not None:
                first, logits = self.backend.prefill_prefixed(
                    padded, len(suffix), s, hit, req.prompt)
            else:
                first, logits = self.backend.prefill(padded, len(suffix), s)
            now = self.clock()
            req.state, req.slot = "ACTIVE", s
            req.ttft_s = now - req.submitted_t
            self._ttft_s.append(req.ttft_s)
            self.slots[s] = req
            self.lengths[s] = len(req.prompt)
            self.counters["admitted"] += 1
            self.counters["prompt_tokens"] += len(req.prompt)
            if hit:
                self.counters["prefix_hits"] += 1
                self.counters["prefix_hit_tokens"] += hit
            if self.collective is not None:
                self.collective.timeline_instant(
                    "SERVING_ADMIT", f"req={req.rid} slot={s} "
                    f"len={len(req.prompt)} bucket={bucket}")
                if hit:
                    self.collective.timeline_instant(
                        "SERVING_PREFIX_HIT", f"req={req.rid} slot={s} "
                        f"tokens={hit} suffix={len(suffix)}")
            self._take_token(req, s, first, logits, now)
            if req.state == "DONE":  # max_new_tokens == 1
                self._evict(req, s, done)

    def _take_token(self, req: Request, slot: int, token: int, logits,
                    now: float) -> None:
        req.tokens.append(token)
        if self.config.record_logits:
            req.logits.append(np.array(logits))
        if req._last_token_t:
            req.token_lat_s.append(now - req._last_token_t)
            self._token_s.append(req.token_lat_s[-1])
        req._last_token_t = now
        self.last_tokens[slot] = token
        self.lengths[slot] += 1
        self.counters["tokens"] += 1
        total = len(req.prompt) + len(req.tokens)
        if self.config.eos_id is not None and token == self.config.eos_id:
            req.state, req.finish_reason = "DONE", "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.state, req.finish_reason = "DONE", "max_new_tokens"
        elif total >= self.config.max_seq_len:
            req.state, req.finish_reason = "DONE", "max_seq_len"

    def _spec_ready(self) -> bool:
        """Speculate this step?  Needs a verify-capable backend, a draft
        window, and room for the k+1-position block in every slot."""
        k = self.config.spec_k
        return (k > 0 and hasattr(self.backend, "verify")
                and int(self.lengths.max()) + k <= self.config.max_seq_len)

    def _propose(self, req: Request, k: int) -> list[int]:
        """n-gram prompt lookup: continue the latest earlier occurrence of
        the trailing ``spec_ngram`` tokens, then of the last token, else
        repeat the last token."""
        hist = req.prompt + req.tokens
        orders = (self.config.spec_ngram, 1) if self.config.spec_ngram > 1 \
            else (1,)
        for m in orders:
            if len(hist) < m + 1:
                continue
            pat = hist[-m:]
            for i in range(len(hist) - m - 1, -1, -1):
                if hist[i:i + m] == pat:
                    cont = hist[i + m:i + m + k]
                    out = list(cont)
                    while len(out) < k:
                        out.extend(cont[:k - len(out)])
                    return out[:k]
        return [hist[-1]] * k

    def _spec_step(self, done: list[Request]) -> None:
        k = self.config.spec_k
        drafts = np.zeros((self.config.num_slots, k), np.int32)
        for s, req in enumerate(self.slots):
            if req is not None:
                drafts[s] = self._propose(req, k)
        tok_block = np.concatenate([self.last_tokens[:, None], drafts],
                                   axis=1)
        preds, logits = self.backend.verify(tok_block, self.lengths)
        now = self.clock()
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            # Accept drafts left to right while they match the model's own
            # greedy prediction, then take the model's token at the first
            # divergence (or the bonus token): the stream is plain decode's.
            taken = 0
            while taken < k and req.state == "ACTIVE" and \
                    int(preds[s, taken]) == int(drafts[s, taken]):
                self._take_token(req, s, int(drafts[s, taken]),
                                 logits[s, taken], now)
                taken += 1
            if req.state == "ACTIVE":
                self._take_token(req, s, int(preds[s, taken]),
                                 logits[s, taken], now)
            self.counters["spec_drafted"] += k
            self.counters["spec_accepted"] += taken
            if self.collective is not None and taken:
                self.collective.timeline_instant(
                    "SERVING_SPEC_ACCEPT",
                    f"req={req.rid} slot={s} accepted={taken}/{k}")
            if req.state == "DONE":
                self._evict(req, s, done)

    def _evict(self, req: Request, slot: int, done: list[Request]) -> None:
        self.slots[slot] = None
        self.last_tokens[slot] = 0
        self.lengths[slot] = 0
        if self.prefix is not None:
            self.prefix.release(slot)
        if getattr(self.backend, "paged", False):
            self.backend.release_slot(slot)
        self.counters["evicted"] += 1
        self.counters["completed"] += 1
        if self.collective is not None:
            self.collective.timeline_instant(
                "SERVING_EVICT", f"req={req.rid} slot={slot} "
                f"reason={req.finish_reason} new={len(req.tokens)}")
        done.append(req)

    def announce_drained(self) -> int:
        """This replica is done: enqueue the one-shot ``serving.drained``
        collective, which the coordinator dispatches once every replica
        announced it; returns its handle for :meth:`at_leave_point`."""
        from horovod_tpu_torch.core.engine import OP_ALLREDUCE

        return self.collective.enqueue(self.DRAINED_NAME,
                                       np.zeros(1, np.float32), OP_ALLREDUCE)

    def at_leave_point(self, drained_handle: int) -> bool:
        """Whether the fleet may leave after the tick just completed: the
        drained collective has completed and the tick ran after it (or in
        its batch).  The tick ordered first after the drain is the same
        on every replica, so every replica leaves after the same tick; a
        replica that sees the drain complete behind its tick ticks once
        more, with everyone else, instead of leaving a peer waiting on a
        tick that would never complete."""
        eng = self.collective
        return eng.poll(drained_handle) and \
            eng.applied_order(self.tick_name) >= \
            eng.applied_order(self.DRAINED_NAME)

    def _tick_collective(self) -> None:
        if self.collective is None:
            return
        from horovod_tpu_torch.core.engine import OP_ALLREDUCE

        t0 = time.monotonic()
        c = self.counters
        vec = np.array([self._active_count(), len(self.queue), c["admitted"],
                        c["evicted"], c["completed"], c["tokens"], c["steps"],
                        self._occupancy(), self.done_flag], np.float32)
        # Fixed name + shape + dtype every tick: after the first step the
        # signature is a response-cache hit, never renegotiated.
        h = self.collective.enqueue(self.tick_name, vec, OP_ALLREDUCE)
        agg = self.collective.synchronize(h)
        self.fleet = dict(zip(("active", "queued", "admitted", "evicted",
                               "completed", "tokens", "steps", "occupancy",
                               "done_replicas"),
                              (float(x) for x in agg)))
        self._tick_s.append(time.monotonic() - t0)

    # -- draining & introspection -----------------------------------------

    def run_until_idle(self, max_steps: int = 100000) -> list[Request]:
        out: list[Request] = []
        for _ in range(max_steps):
            if not self.queue and self._active_count() == 0:
                out.extend(self._undelivered)  # parked by an aborted tick
                self._undelivered = []
                return out
            out.extend(self.step())
        raise RuntimeError("serving engine did not drain "
                           f"within {max_steps} steps")

    def _active_count(self) -> int:
        return sum(r is not None for r in self.slots)

    def _occupancy(self) -> float:
        return float(np.sum(self.lengths)) / (
            self.config.num_slots * self.config.max_seq_len)

    def stats(self) -> dict:
        c = self.counters
        return {
            "active_slots": self._active_count(),
            "queue_depth": len(self.queue),
            "admitted": c["admitted"], "evicted": c["evicted"],
            "completed": c["completed"], "rejected": c["rejected"],
            "retried": c["retried"], "steps": c["steps"],
            "tokens": c["tokens"],
            "ttft_p50_ms": _pctile(self._ttft_s, 50) * 1e3,
            "ttft_p99_ms": _pctile(self._ttft_s, 99) * 1e3,
            "token_p50_ms": _pctile(self._token_s, 50) * 1e3,
            "token_p99_ms": _pctile(self._token_s, 99) * 1e3,
            "kv_slot_occupancy": self._occupancy(),
            "prefix_hits": c["prefix_hits"],
            "prefix_hit_tokens": c["prefix_hit_tokens"],
            "prefix_evictions": self.prefix.evictions if self.prefix else 0,
            "prefix_hit_rate": (c["prefix_hit_tokens"]
                                / max(c["prompt_tokens"], 1)),
            "spec_drafted": c["spec_drafted"],
            "spec_accepted": c["spec_accepted"],
            "spec_accept_rate": (c["spec_accepted"]
                                 / max(c["spec_drafted"], 1)),
            **(self.backend.kv_read_stats()
               if hasattr(self.backend, "kv_read_stats") else {}),
        }


    def tick_stats(self) -> dict:
        """Host time of the ``collective=`` tick: ``{"ticks", "tick_mean_ms",
        "tick_p99_ms"}`` over every completed tick (zeros without one)."""
        n = len(self._tick_s)
        return {"ticks": n,
                "tick_mean_ms": sum(self._tick_s) / n * 1e3 if n else 0.0,
                "tick_p99_ms": _pctile(self._tick_s, 99) * 1e3}


def serving_stats() -> dict:
    """Scheduler counters of this process's most recent
    :class:`ServingEngine`; all zeros when none was constructed."""
    if _ACTIVE is None:
        return {k: 0.0 if k in _FLOAT_STATS else 0 for k in _STATS_KEYS}
    return _ACTIVE.stats()
