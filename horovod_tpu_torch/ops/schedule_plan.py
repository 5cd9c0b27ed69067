"""Overlap schedule planning for :class:`DistributedOptimizer`'s gradient
buckets — the bucket half of ``horovod_tpu/ops/schedule_plan.py``.

The overlap itself is the reference Horovod's: each bucket's allreduce is
issued while backward is still producing the gradients of earlier layers
(``training.py``, post-accumulate-grad hooks).  Whether to overlap, and
over how many buckets, is this module's call, made once per gradient set
from what is known before the first step: the tensors' bytes and dtypes
(:class:`GradientManifest`), the data-parallel width, and a device-memory
headroom estimate (:func:`probe_headroom_mb`).  A :class:`Planner` maps
those to a :class:`BucketPlan` — a depth, optional bucket bounds, or the
bypass — with the JAX package's names, fields, reasons and resolution
order:

* :class:`AdaptivePlanner` (the default when no override is present):
  bypasses at width 1 (the allreduce is the identity there: no hook and no
  collective), halves the depth while the estimated extra live bytes pass
  the headroom, and keeps depth 4 at real width with slack headroom;
* :class:`StaticPlanner`: ``overlap_buckets=`` or a set
  ``HOROVOD_OVERLAP_BUCKETS`` / ``HVD_TPU_OVERLAP_BUCKETS`` pin a depth,
  whatever the width or headroom.

**The plan agrees across ranks.**  In eager PyTorch every rank issues its
own collectives, and NCCL deadlocks when two ranks issue different
sequences, so every rank must make the same plan.  The planners are
deterministic functions of (manifest, width, headroom); manifest and width
are the same on every rank of a data-parallel job, and so are the
environment knobs, as the JAX package assumes for its SPMD programs.  The
one input that can differ is the probed headroom: :func:`probe_headroom_mb`
agrees it first, once per process, as the minimum over the ranks of each
rank's quantized probe (one ``all_reduce(MIN)``).  A set
``HVD_TPU_DEVICE_HEADROOM_MB`` skips the probe and its collective.

Every decision is observable: :func:`overlap_plan` returns the last plan,
rank 0 logs one line per distinct decision, and each distinct decision puts
an ``OVERLAP_PLAN`` instant on the eager engine's timeline when an engine
is running with one (``HOROVOD_TIMELINE``), as the JAX package does.

The long-context half, :func:`plan_context`, makes one
:class:`ContextPlan` per long-context workload (shard width, plain or
zigzag layout, the flash kernels' tiles, the remat policy) for
``parallel/context.py`` and ``models/transformer.py``; its decisions are
the JAX package's, except for the tiles, which are the port's kernels'
own (see :class:`ContextPlan`).  :func:`context_plan` returns the last one,
and a ``CONTEXT_PLAN`` instant lands beside ``OVERLAP_PLAN``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.utils import env

_log = logging.getLogger("horovod_tpu_torch")

# Fraction of the total gradient bytes that overlapping keeps extra-live at
# peak, per unit of (depth-1)/depth: the JAX package's calibration, kept so
# that both packages plan alike (its derivation: ops/schedule_plan.py).
# The (depth-1)/depth factor makes the estimate monotone in depth and zero
# at depth <= 1, so degrading the depth provably shrinks it.
CHAIN_LIVE_FRACTION = 1.0 / 8.0

# Probed headroom is quantized DOWN to this granularity before planning, so
# allocator jitter does not move the plan.
HEADROOM_QUANTUM_MB = 256.0


@dataclasses.dataclass(frozen=True)
class GradientManifest:
    """Static description of the gradient set a plan covers — per-tensor
    wire bytes and dtype names."""

    nbytes: tuple[int, ...]
    dtypes: tuple[str, ...]

    @classmethod
    def from_tensors(cls, tensors) -> "GradientManifest":
        return cls(nbytes=tuple(t.numel() * t.element_size()
                                for t in tensors),
                   dtypes=tuple(str(t.dtype).removeprefix("torch.")
                                for t in tensors))

    @property
    def count(self) -> int:
        return len(self.nbytes)

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One planner decision for one gradient set.

    ``chain_depth`` <= 1 (or a single tensor) means the bypass: every
    gradient is reduced after backward, at ``step()``.  Otherwise the
    gradients, in reverse order (the order backward produces them), form
    ``chain_depth`` buckets of equal count, or the buckets ``bounds`` gives
    (len ``chain_depth + 1``, ascending, over the reverse-order tensor
    index), each reduced as soon as its last gradient exists."""

    planner: str
    chain_depth: int
    width: int
    tensor_count: int
    total_bytes: int
    headroom_mb: float | None
    chain_extra_bytes: int
    reason: str
    bounds: tuple[int, ...] | None = None

    @property
    def chained(self) -> bool:
        return self.chain_depth > 1 and self.tensor_count > 1

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["chained"] = self.chained
        return d


def chain_extra_bytes(total_bytes: int, depth: int) -> int:
    """Estimated extra peak device bytes of a ``depth``-bucket overlap over
    the bypass (the model :data:`CHAIN_LIVE_FRACTION` documents)."""
    if depth <= 1:
        return 0
    return int(total_bytes * CHAIN_LIVE_FRACTION * (depth - 1) / depth)


class Planner:
    """Interface: manifest + width + headroom -> :class:`BucketPlan`.

    Implementations must be deterministic functions of their arguments:
    every rank makes the plan itself, and the plans must agree.  Pass an
    instance via ``DistributedOptimizer(planner=...)`` or
    ``grouped_allreduce(planner=...)``."""

    name = "abstract"

    def plan(self, manifest: GradientManifest, width: int,
             headroom_mb: float | None) -> BucketPlan:
        raise NotImplementedError


class StaticPlanner(Planner):
    """A fixed bucket count, engaged whenever depth > 1 and there is more
    than one tensor — regardless of width or headroom.
    ``HOROVOD_OVERLAP_BUCKETS`` / explicit ``overlap_buckets=`` route
    here."""

    name = "static"

    def __init__(self, n_buckets: int, source: str = "overlap_buckets"):
        self.n_buckets = int(n_buckets)
        self.source = source

    def plan(self, manifest, width, headroom_mb):
        depth = self.n_buckets if self.n_buckets > 1 else 0
        if manifest.count <= 1:
            depth = 0
        return BucketPlan(
            planner=self.name, chain_depth=depth, width=width,
            tensor_count=manifest.count, total_bytes=manifest.total_bytes,
            headroom_mb=headroom_mb,
            chain_extra_bytes=chain_extra_bytes(manifest.total_bytes, depth),
            reason=f"explicit override via {self.source}="
                   f"{self.n_buckets}")


class AdaptivePlanner(Planner):
    """The default: overlap only where it can pay for itself.

    * width 1 -> bypass (the allreduce is the identity; nothing to
      overlap);
    * headroom deficit -> halve the depth until the estimated extra live
      bytes fit, down to bypass;
    * real width, slack headroom -> depth 4.
    """

    name = "adaptive"

    def __init__(self, default_depth: int | None = None):
        self.default_depth = (env.DEFAULT_OVERLAP_BUCKETS
                              if default_depth is None else int(default_depth))

    def plan(self, manifest, width, headroom_mb):
        def mk(depth, reason):
            return BucketPlan(
                planner=self.name, chain_depth=depth, width=width,
                tensor_count=manifest.count,
                total_bytes=manifest.total_bytes, headroom_mb=headroom_mb,
                chain_extra_bytes=chain_extra_bytes(manifest.total_bytes,
                                                    depth),
                reason=reason)

        # The reasons are the JAX package's, word for word, so that a plan
        # reads the same in both.
        if width <= 1:
            return mk(0, "width-1 bypass: psum is identity, nothing to "
                         "overlap — free-combining structure")
        if manifest.count <= 1:
            return mk(0, "single gradient tensor: nothing to chain")
        depth = self.default_depth
        if depth <= 1:
            return mk(0, f"default depth {depth} disables the chain")
        if headroom_mb is None:
            return mk(depth, f"width {width}, headroom unknown: keeping "
                             f"default depth {depth}")
        budget = headroom_mb * 1024.0 * 1024.0
        if chain_extra_bytes(manifest.total_bytes, depth) <= budget:
            return mk(depth, f"width {width}, headroom {headroom_mb:.0f} MB "
                             f"covers the chain: keeping depth {depth}")
        start = depth
        while depth > 1 and chain_extra_bytes(manifest.total_bytes,
                                              depth) > budget:
            depth //= 2
        if depth <= 1:
            return mk(0, f"headroom deficit: even a 2-bucket chain "
                         f"(+{chain_extra_bytes(manifest.total_bytes, 2)} B) "
                         f"exceeds {headroom_mb:.0f} MB — free-combining "
                         f"fallback")
        return mk(depth, f"headroom deficit: degraded depth {start} -> "
                         f"{depth} to fit {headroom_mb:.0f} MB")


# ---------------------------------------------------------------------------
# Headroom probe
# ---------------------------------------------------------------------------

_probe_lock = threading.Lock()
_probe_cache: list = []  # [float | None] once probed — one answer per process


def _local_headroom_mb() -> float | None:
    """This process's free device memory in MB, quantized down to
    :data:`HEADROOM_QUANTUM_MB`; None off the card."""
    if not (basics.is_initialized() and basics.device().type == "cuda"):
        return None
    free, _ = torch.cuda.mem_get_info(basics.device())
    mb = free / (1024.0 * 1024.0)
    return (mb // HEADROOM_QUANTUM_MB) * HEADROOM_QUANTUM_MB


def _agree_headroom(mb: float | None) -> float | None:
    """The minimum of every rank's ``mb`` (None if any rank's is None):
    one ``all_reduce(MIN)`` over the job."""
    t = torch.tensor([-1.0 if mb is None else mb], dtype=torch.float64,
                     device=basics.device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=basics.process_group())
    low = float(t.item())
    return None if low < 0 else low


def probe_headroom_mb() -> float | None:
    """Device-memory headroom estimate in MB, or None when unknowable.

    ``HVD_TPU_DEVICE_HEADROOM_MB`` wins when set.  Otherwise the free
    memory of this process's card (``torch.cuda.mem_get_info``), quantized
    down to :data:`HEADROOM_QUANTUM_MB`, and agreed across the job as the
    minimum over the ranks, so every rank plans the same; None on the CPU.
    The answer is cached for the process's lifetime: the plan does not
    drift as buffers come and go."""
    override = env.device_headroom_mb()
    if override is not None:
        return override
    with _probe_lock:
        if _probe_cache:
            return _probe_cache[0]
        headroom = _local_headroom_mb()
        if basics.is_initialized() and basics.size() > 1:
            headroom = _agree_headroom(headroom)
        _probe_cache.append(headroom)
        return headroom


# ---------------------------------------------------------------------------
# Entry point + observability
# ---------------------------------------------------------------------------

_plan_lock = threading.Lock()
_last_plan: BucketPlan | None = None
_logged_keys: set = set()


def plan_overlap(tensors, width: int, override: int | None = None,
                 planner: Planner | None = None) -> BucketPlan:
    """Make (and record) the bucket plan for one gradient set.

    Resolution order — most explicit wins:

    1. a ``planner`` instance passed in code;
    2. an explicit ``overlap_buckets=`` argument (``override``) ->
       :class:`StaticPlanner`;
    3. a set ``HOROVOD_OVERLAP_BUCKETS`` / ``HVD_TPU_OVERLAP_BUCKETS`` ->
       :class:`StaticPlanner` (a malformed value degrades to the default
       with a warning);
    4. :class:`AdaptivePlanner`.
    """
    if planner is None:
        if override is not None:
            planner = StaticPlanner(override, source="overlap_buckets")
        else:
            env_depth = env.overlap_buckets_override()
            if env_depth is not None:
                planner = StaticPlanner(env_depth,
                                        source="HOROVOD_OVERLAP_BUCKETS")
            else:
                planner = AdaptivePlanner()
    manifest = GradientManifest.from_tensors(tensors)
    plan = planner.plan(manifest, width, probe_headroom_mb())
    _record(plan)
    return plan


def overlap_plan() -> dict | None:
    """The most recent :class:`BucketPlan` as a dict
    (``hvd.overlap_plan()``), or None before any gradient set has been
    planned.  Keys: planner, chain_depth, chained, width, tensor_count,
    total_bytes, headroom_mb, chain_extra_bytes, bounds, reason."""
    with _plan_lock:
        return _last_plan.as_dict() if _last_plan is not None else None


def _record(plan: BucketPlan) -> None:
    global _last_plan
    key = (plan.planner, plan.chain_depth, plan.width, plan.tensor_count,
           plan.total_bytes, plan.headroom_mb, plan.bounds)
    with _plan_lock:
        _last_plan = plan
        fresh = key not in _logged_keys
        if fresh:
            _logged_keys.add(key)
    if not fresh:
        return
    hr = ("unknown" if plan.headroom_mb is None
          else f"{plan.headroom_mb:.0f}MB")
    if _is_rank0():
        _log.info(
            "overlap plan: planner=%s width=%d headroom=%s depth=%d "
            "tensors=%d bytes=%d — %s", plan.planner, plan.width, hr,
            plan.chain_depth, plan.tensor_count, plan.total_bytes,
            plan.reason)
    _timeline_instant(
        "overlap_plan",
        f"OVERLAP_PLAN planner={plan.planner} width={plan.width} "
        f"headroom={hr} depth={plan.chain_depth}")


def _timeline_instant(row: str, label: str) -> None:
    """An instant on the running eager engine's timeline (peeked, never
    started; a no-op without a timeline file)."""
    from horovod_tpu_torch.core import engine

    eng = engine.peek_engine()
    if eng is not None:
        eng.timeline_instant(row, label)


def _is_rank0() -> bool:
    return not basics.is_initialized() or basics.rank() == 0


def _reset_for_tests() -> None:
    """Drop the cached probe and log state (test isolation only)."""
    global _last_plan, _last_context_plan
    with _probe_lock:
        _probe_cache.clear()
    with _plan_lock:
        _last_plan = None
        _logged_keys.clear()
        _last_context_plan = None
        _context_logged_keys.clear()


# ---------------------------------------------------------------------------
# ContextPlan: long-context layout planning (ring / zigzag flash attention)
# ---------------------------------------------------------------------------
# Shard width, plain-or-zigzag layout, the remat policy and the flash tiles
# are one decision from one memory model, not four hand-set knobs.

# Remat engages past this many MB of estimated activations a rank when no
# headroom is known (the CPU, or no HVD_TPU_DEVICE_HEADROOM_MB): the JAX
# package's constant, kept so that both plan alike there.
DEFAULT_CTX_REMAT_THRESHOLD_MB = 2048.0


@dataclasses.dataclass(frozen=True)
class ContextWorkload:
    """Static description of one long-context training workload; the plan
    is a deterministic function of (workload, width, headroom), so every
    rank makes the same one."""

    seq_len: int
    num_heads: int
    head_dim: int
    batch: int = 1
    embed_dim: int = 0       # 0 -> num_heads * head_dim
    mlp_dim: int = 0         # 0 -> 4 * model_dim
    num_layers: int = 1
    causal: bool = True
    dtype_bytes: int = 2     # bf16 activations

    @property
    def model_dim(self) -> int:
        return self.embed_dim or self.num_heads * self.head_dim

    @property
    def ff_dim(self) -> int:
        return self.mlp_dim or 4 * self.model_dim

    def activation_mb(self, width: int) -> float:
        """Estimated live activation MB a rank without remat: the residual
        stream, the attention q/k/v/out set and the MLP hidden, per layer
        and local token (the JAX package's model: it prices a binary remat
        decision, not an allocator)."""
        per_token = (2 * self.model_dim + 4 * self.num_heads * self.head_dim
                     + 2 * self.ff_dim) * self.dtype_bytes
        s_local = max(self.seq_len // max(width, 1), 1)
        return (self.num_layers * self.batch * s_local * per_token
                / (1024.0 * 1024.0))


@dataclasses.dataclass(frozen=True)
class ContextPlan:
    """One planner decision for one long-context workload: the sequence
    layout (``plain`` / ``zigzag``), the remat policy, and the flash tiles.

    ``width``, ``seq_local``, ``layout``, ``remat``, ``causal``,
    ``headroom_mb`` and ``est_activation_mb`` are the JAX package's
    decisions on the same inputs.  The tiles are not: the JAX plan picks
    ``block_q`` / ``block_k`` for its Pallas kernels and fits them to TPU
    VMEM (``est_vmem_kb``), while the port's kernels choose their own tiles
    at launch from the head dim, the dtype and the grid.  So here
    ``block_q`` and ``block_k`` are the tiles the forward kernel runs at
    one call of this plan (a zigzag half-pair or a plain shard),
    ``tiles`` gives ``[block_q, block_k, shared-memory bytes]`` for each of
    the three flash kernels (``ops.flash_attention.kernel_tiles``), and
    ``smem_bytes``, in place of ``est_vmem_kb``, is the largest of their
    blocks' shared memory.  No tile can be pinned: the JAX package's
    ``block_q=`` / ``block_k=`` keywords and ``HVD_TPU_CTX_BLOCK_*``
    variables have no counterpart here."""

    planner: str
    width: int
    seq_local: int
    layout: str
    block_q: int
    block_k: int
    remat: bool
    causal: bool
    headroom_mb: float | None
    smem_bytes: int
    tiles: dict
    est_activation_mb: float
    reason: str

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tiles"] = {k: list(v) for k, v in self.tiles.items()}
        return d


def plan_context(workload: ContextWorkload, width: int,
                 headroom_mb: float | None = None, *,
                 layout: str | None = None,
                 remat: bool | None = None) -> ContextPlan:
    """Make (and record) the long-context plan for one workload.

    Resolution order per field, most explicit first: a keyword argument,
    the ``HVD_TPU_CTX_*`` environment override, then the planner.
    ``headroom_mb`` defaults to :func:`probe_headroom_mb`, the memory model
    the bucket planner budgets against."""
    from horovod_tpu_torch.ops.flash_attention import kernel_tiles

    if width < 1:
        raise ValueError(f"context width must be >= 1, got {width}")
    if workload.seq_len % width:
        raise ValueError(
            f"seq_len {workload.seq_len} not divisible by context width "
            f"{width}")
    s_local = workload.seq_len // width
    if headroom_mb is None:
        headroom_mb = probe_headroom_mb()

    why = []
    layout = layout if layout is not None else env.ctx_layout()
    if layout in (None, "auto"):
        zig_ok = workload.seq_len % (2 * width) == 0 and width > 1
        if workload.causal and zig_ok:
            layout = "zigzag"
            why.append("causal multi-shard -> zigzag (balanced causal "
                       "triangle; plain would idle early ranks)")
        else:
            layout = "plain"
            why.append("plain layout ("
                       + ("width 1" if width <= 1 else
                          "non-causal" if not workload.causal else
                          "seq_len not divisible by 2*width")
                       + ("; causal step skipping active"
                          if workload.causal and width > 1 else "") + ")")
    else:
        why.append(f"layout pinned to {layout}")
    if layout == "zigzag" and workload.seq_len % (2 * width):
        raise ValueError(
            f"zigzag needs seq_len divisible by 2*width "
            f"({workload.seq_len} vs width={width})")

    # One kernel call's queries: a zigzag shard is two chunks.
    chunk = max(s_local // 2 if layout == "zigzag" else s_local, 1)
    tiles = kernel_tiles(workload.head_dim, workload.dtype_bytes, chunk,
                         workload.batch * workload.num_heads)
    bq, bk, _ = tiles["flash_fwd"]
    why.append(f"Hopper tiles: forward {bq}x{bk}")

    act_mb = workload.activation_mb(width)
    remat = remat if remat is not None else env.ctx_remat_override()
    if remat is None:
        act_budget = (headroom_mb if headroom_mb is not None
                      else DEFAULT_CTX_REMAT_THRESHOLD_MB)
        remat = act_mb > act_budget
        why.append(
            f"activations ~{act_mb:.0f}MB vs "
            + (f"headroom {headroom_mb:.0f}MB" if headroom_mb is not None
               else f"default budget {act_budget:.0f}MB")
            + (" -> full-layer remat" if remat
               else " -> remat dropped (ring shards the sequence)"))
    else:
        why.append(f"remat pinned to {remat}")

    plan = ContextPlan(
        planner="context", width=width, seq_local=s_local, layout=layout,
        block_q=bq, block_k=bk, remat=bool(remat), causal=workload.causal,
        headroom_mb=headroom_mb,
        smem_bytes=max(t[2] for t in tiles.values()), tiles=tiles,
        est_activation_mb=round(act_mb, 3), reason="; ".join(why))
    _record_context(plan)
    return plan


_last_context_plan: ContextPlan | None = None
_context_logged_keys: set = set()


def context_plan() -> dict | None:
    """The most recent :class:`ContextPlan` as a dict
    (``hvd.context_plan()``), or None before any long-context workload has
    been planned."""
    with _plan_lock:
        return (_last_context_plan.as_dict()
                if _last_context_plan is not None else None)


def _record_context(plan: ContextPlan) -> None:
    global _last_context_plan
    key = (plan.width, plan.seq_local, plan.layout, plan.block_q,
           plan.block_k, plan.remat, plan.causal, plan.headroom_mb)
    with _plan_lock:
        _last_context_plan = plan
        fresh = key not in _context_logged_keys
        if fresh:
            _context_logged_keys.add(key)
    if not fresh:
        return
    if _is_rank0():
        hr = ("unknown" if plan.headroom_mb is None
              else f"{plan.headroom_mb:.0f}MB")
        _log.info(
            "context plan: width=%d s_local=%d layout=%s block_q=%d "
            "block_k=%d remat=%s headroom=%s — %s", plan.width,
            plan.seq_local, plan.layout, plan.block_q, plan.block_k,
            plan.remat, hr, plan.reason)
    _timeline_instant(
        "context_plan",
        f"CONTEXT_PLAN width={plan.width} layout={plan.layout} "
        f"block_q={plan.block_q} block_k={plan.block_k} "
        f"remat={plan.remat}")
