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
and rank 0 logs one line per distinct decision.  The JAX package also puts
an ``OVERLAP_PLAN`` instant on the native engine's timeline; the port has
no engine yet, so only the log line is written.  The long-context
``ContextPlan`` half of the JAX module is not ported yet.
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
    if fresh and _is_rank0():
        hr = ("unknown" if plan.headroom_mb is None
              else f"{plan.headroom_mb:.0f}MB")
        _log.info(
            "overlap plan: planner=%s width=%d headroom=%s depth=%d "
            "tensors=%d bytes=%d — %s", plan.planner, plan.width, hr,
            plan.chain_depth, plan.tensor_count, plan.total_bytes,
            plan.reason)


def _is_rank0() -> bool:
    return not basics.is_initialized() or basics.rank() == 0


def _reset_for_tests() -> None:
    """Drop the cached probe and log state (test isolation only)."""
    global _last_plan
    with _probe_lock:
        _probe_cache.clear()
    with _plan_lock:
        _last_plan = None
        _logged_keys.clear()
