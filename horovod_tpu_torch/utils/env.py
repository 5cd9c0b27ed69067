"""Environment knobs the port reads: tensor fusion, gradient overlap, the
device headroom, ``HVD_TPU_SERVE_*``, and those of the native core, its
elastic membership, checkpointing, the coordinator tree and the bulk data
plane.

Own copy of those readers of ``horovod_tpu/utils/env.py``, with the same
names, defaults and parsing:
each knob is looked up as ``HOROVOD_<name>`` first, then
``HVD_TPU_<name>``.  For the serving knobs, unset gives the default, and a
malformed value gives the default with a warning — a bad knob never takes
a serving replica down.  The overlap and headroom knobs degrade the same
way (:func:`overlap_buckets`, :func:`device_headroom_mb`).
"""

from __future__ import annotations

import os
import warnings

DEFAULT_BUCKETS = (16, 32, 64, 128)
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Fused buckets are padded to a multiple of this many elements.  The JAX
# package pads to the TPU lane width; the port keeps 128 so that both plan
# the same buckets for the same gradients.
FUSION_BUFFER_ATOMIC_UNIT = 128


def _get(name: str, default: str | None = None) -> str | None:
    return os.environ.get("HOROVOD_" + name,
                          os.environ.get("HVD_TPU_" + name, default))


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` — byte budget of one fused bucket
    (default 64 MiB)."""
    raw = _get("FUSION_THRESHOLD")
    return int(raw) if raw else DEFAULT_FUSION_THRESHOLD


DEFAULT_OVERLAP_BUCKETS = 4


def overlap_buckets() -> int:
    """Number of gradient buckets whose allreduces overlap backward
    (``HOROVOD_OVERLAP_BUCKETS`` / ``HVD_TPU_OVERLAP_BUCKETS``; 0
    disables).  A malformed value (non-integer, or negative) falls back to
    the default with a warning instead of crashing the job at its first
    step."""
    raw = _get("OVERLAP_BUCKETS")
    if not raw:
        return DEFAULT_OVERLAP_BUCKETS
    try:
        value = int(raw)
        if value < 0:
            raise ValueError("negative bucket count")
    except ValueError:
        name = ("HOROVOD_OVERLAP_BUCKETS"
                if "HOROVOD_OVERLAP_BUCKETS" in os.environ
                else "HVD_TPU_OVERLAP_BUCKETS")
        warnings.warn(
            f"{name}={raw!r} is not a non-negative integer; falling back "
            f"to the default ({DEFAULT_OVERLAP_BUCKETS})",
            RuntimeWarning, stacklevel=2)
        return DEFAULT_OVERLAP_BUCKETS
    return value


def overlap_buckets_override() -> int | None:
    """The explicitly requested bucket count, or None when the environment
    carries no override: unset lets the adaptive planner choose
    (``ops/schedule_plan.py``), while any set value, 0 included, pins the
    static planner.  A set but malformed value degrades to
    :data:`DEFAULT_OVERLAP_BUCKETS` with :func:`overlap_buckets`'s
    warning."""
    raw = _get("OVERLAP_BUCKETS")
    if not raw:
        return None
    return overlap_buckets()


def device_headroom_mb() -> float | None:
    """``HVD_TPU_DEVICE_HEADROOM_MB`` — device-memory headroom (MB) the
    schedule planner budgets the overlap's extra live bytes against, in
    place of the ``torch.cuda.mem_get_info`` probe.  Unset or malformed
    (with a warning): None (probe, or treat headroom as unknown); negative
    values clamp to 0 (no headroom)."""
    raw = _get("DEVICE_HEADROOM_MB")
    if raw in (None, ""):
        return None
    try:
        value = float(raw)
    except ValueError:
        name = ("HOROVOD_DEVICE_HEADROOM_MB"
                if "HOROVOD_DEVICE_HEADROOM_MB" in os.environ
                else "HVD_TPU_DEVICE_HEADROOM_MB")
        warnings.warn(
            f"{name}={raw!r} is not a number; ignoring the override "
            f"(headroom stays unknown)", RuntimeWarning, stacklevel=2)
        return None
    return max(value, 0.0)


def _serve_number(name: str, default, cast, floor=None):
    raw = _get(name)
    if raw in (None, ""):
        return default
    try:
        value = cast(raw)
        if floor is not None and value < floor:
            raise ValueError("below floor")
    except ValueError:
        warnings.warn(
            f"HVD_TPU_{name}={raw!r} is not a valid value; using the "
            f"default {default}", RuntimeWarning, stacklevel=3)
        return default
    return value


def serve_slots() -> int:
    """``HVD_TPU_SERVE_SLOTS`` — KV-cache slots (default 8)."""
    return _serve_number("SERVE_SLOTS", 8, int, floor=1)


def serve_buckets() -> tuple[int, ...]:
    """``HVD_TPU_SERVE_BUCKETS`` — ascending prefill length menu (CSV;
    default ``16,32,64,128``)."""
    raw = _get("SERVE_BUCKETS")
    if raw in (None, ""):
        return DEFAULT_BUCKETS
    try:
        buckets = tuple(sorted(int(b) for b in raw.split(",") if b.strip()))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError("empty or non-positive bucket")
    except ValueError:
        warnings.warn(
            f"HVD_TPU_SERVE_BUCKETS={raw!r} is not an ascending int CSV; "
            "using the default (16,32,64,128)", RuntimeWarning, stacklevel=3)
        return DEFAULT_BUCKETS
    return buckets


def serve_max_len() -> int:
    """``HVD_TPU_SERVE_MAX_LEN`` — per-slot KV-cache length (default
    256)."""
    return _serve_number("SERVE_MAX_LEN", 256, int, floor=2)


def serve_queue_high() -> float:
    """``HVD_TPU_SERVE_QUEUE_HIGH`` — autoscaler GROW threshold in queued
    requests per replica (default 16)."""
    return _serve_number("SERVE_QUEUE_HIGH", 16.0, float, floor=0.0)


def serve_p99_ms() -> float:
    """``HVD_TPU_SERVE_P99_MS`` — autoscaler GROW threshold on p99 TTFT
    in ms (default 500; 0 disables the latency trigger)."""
    return _serve_number("SERVE_P99_MS", 500.0, float, floor=0.0)


def serve_idle_s() -> float:
    """``HVD_TPU_SERVE_IDLE_S`` — idle seconds before the autoscaler
    SHRINKs (default 5)."""
    return _serve_number("SERVE_IDLE_S", 5.0, float, floor=0.0)


def serve_min_replicas() -> int:
    """``HVD_TPU_SERVE_MIN_REPLICAS`` — autoscaler floor (default 1)."""
    return _serve_number("SERVE_MIN_REPLICAS", 1, int, floor=1)


def serve_max_replicas() -> int:
    """``HVD_TPU_SERVE_MAX_REPLICAS`` — autoscaler ceiling (default 8)."""
    return _serve_number("SERVE_MAX_REPLICAS", 8, int, floor=1)


def serve_cooldown_s() -> float:
    """``HVD_TPU_SERVE_COOLDOWN_S`` — minimum seconds between autoscale
    decisions (default 2)."""
    return _serve_number("SERVE_COOLDOWN_S", 2.0, float, floor=0.0)


def serve_prefix_pages() -> int:
    """``HVD_TPU_SERVE_PREFIX_PAGES`` — shared-prefix cache slack in
    pages (default 0 = off)."""
    return _serve_number("SERVE_PREFIX_PAGES", 0, int, floor=0)


def serve_page_tokens() -> int:
    """``HVD_TPU_SERVE_PAGE_TOKENS`` — tokens per KV page (default 16)."""
    return _serve_number("SERVE_PAGE_TOKENS", 16, int, floor=1)


def serve_spec_k() -> int:
    """``HVD_TPU_SERVE_SPEC_K`` — speculative draft window (default 0 =
    off)."""
    return _serve_number("SERVE_SPEC_K", 0, int, floor=0)


def serve_slo_ms() -> float:
    """``HVD_TPU_SERVE_SLO_MS`` — default TTFT SLO in ms a routed model is
    judged against (``serving/router.py`` ``ModelSpec``; default 100)."""
    return _serve_number("SERVE_SLO_MS", 100.0, float, floor=0.0)


def serve_qps() -> float:
    """``HVD_TPU_SERVE_QPS`` — Poisson arrival rate of the self-driven
    workload (default 20)."""
    return _serve_number("SERVE_QPS", 20.0, float, floor=0.001)


def serve_duration_s() -> float:
    """``HVD_TPU_SERVE_DURATION_S`` — workload duration (default 3)."""
    return _serve_number("SERVE_DURATION_S", 3.0, float, floor=0.01)


# -- the native core (core/src) and its control plane ---------------------

DEFAULT_CYCLE_TIME_MS = 5.0
STALL_WARNING_TIME_SECONDS = 60.0


def cycle_time_ms() -> float:
    raw = _get("CYCLE_TIME")
    return float(raw) if raw else DEFAULT_CYCLE_TIME_MS


def timeline_path() -> str | None:
    return _get("TIMELINE")


DEFAULT_CACHE_CAPACITY = 1024


def cache_capacity() -> int:
    """``HOROVOD_CACHE_CAPACITY`` — response-cache entries (0 disables;
    default 1024, upstream 0.16's default).  docs/response_cache.md."""
    raw = _get("CACHE_CAPACITY")
    return int(raw) if raw not in (None, "") else DEFAULT_CACHE_CAPACITY


def stall_check_disabled() -> bool:
    return _get("STALL_CHECK_DISABLE") is not None


def stall_warning_seconds() -> float:
    """Stall-warning window; reference hardcodes 60 s (operations.cc:253) —
    exposed as a knob here mainly so tests can shrink it."""
    raw = _get("STALL_WARNING_TIME")
    return float(raw) if raw else STALL_WARNING_TIME_SECONDS


# Restartable abort (EX_TEMPFAIL): the launcher's supervision treats this
# exit as "transient, relaunch me" — the stall escalation and any rank that
# wants an explicit restart use it.
STALL_ABORT_EXIT_CODE = 75


def stall_abort_seconds() -> float:
    """Stall warn->abort escalation threshold; 0 (default) disables."""
    raw = _get("STALL_ABORT_SECONDS")
    return float(raw) if raw else 0.0


def stall_abort_exit_code() -> int:
    raw = _get("STALL_ABORT_EXIT_CODE")
    return int(raw) if raw else STALL_ABORT_EXIT_CODE


DEFAULT_ABORT_GRACE_MS = 1000.0


def abort_grace_ms() -> float:
    """Grace between a peer-failure abort and the restartable process exit
    (``HVD_TPU_ABORT_GRACE_MS``; negative = report only, never exit)."""
    raw = _get("ABORT_GRACE_MS")
    return float(raw) if raw not in (None, "") else DEFAULT_ABORT_GRACE_MS


def verify_schedule() -> bool:
    """``HVD_TPU_VERIFY_SCHEDULE`` — debug-mode cross-rank schedule
    verification (analysis/schedule.py): every submitted collective extends
    a rolling hash the coordinator compares across ranks, turning a
    divergent collective order into an immediate coordinated abort with a
    structured report instead of a stall-timeout hang."""
    raw = _get("VERIFY_SCHEDULE")
    return bool(raw) and raw not in ("0", "false", "False")


DEFAULT_VERIFY_INTERVAL_TICKS = 10


def verify_interval_ticks() -> int:
    """Coordinator ticks between cross-rank schedule checks
    (``HVD_TPU_VERIFY_INTERVAL_TICKS``; default 10 — ~50 ms at the default
    5 ms cycle, cheap enough to leave on for whole debug runs)."""
    raw = _get("VERIFY_INTERVAL_TICKS")
    return int(raw) if raw else DEFAULT_VERIFY_INTERVAL_TICKS


DEFAULT_RECONFIG_TIMEOUT_MS = 30000.0


def elastic_enabled() -> bool:
    """``HVD_TPU_ELASTIC`` — in-place elastic recovery
    (docs/fault_tolerance.md "In-place recovery"): when a non-coordinator
    rank dies, survivors shrink to the new membership in the same process
    (RECONFIG broadcast + engine re-form) instead of exiting 75 for a full
    relaunch; the launcher's ``--elastic`` mode relaunches only the dead
    rank, which rejoins via JOIN.  Coordinator death and shrinks below
    ``HVD_TPU_MIN_SIZE`` keep the full-restart path.  Read natively in
    core/src/c_api.cc."""
    raw = _get("ELASTIC")
    return bool(raw) and raw not in ("0", "false", "False")


def reconfig_timeout_ms() -> float:
    """``HVD_TPU_RECONFIG_TIMEOUT_MS`` — bound (default 30000) on the
    whole in-place reconfiguration: an unacknowledged resize event, or a
    re-rendezvous that cannot complete within it, falls back to
    abort-and-restart so nothing blocks forever (the PR-4 guarantee)."""
    raw = _get("RECONFIG_TIMEOUT_MS")
    return float(raw) if raw not in (None, "") \
        else DEFAULT_RECONFIG_TIMEOUT_MS


def ckpt_replicate() -> bool:
    """``HVD_TPU_CKPT_REPLICATE`` — peer-replicate each rank's snapshot to
    a neighbor rank's host memory over the control plane (SHARD_PUT
    frames), so an elastic restore can skip disk entirely when a replica
    from the current membership epoch survives (replication.py)."""
    raw = _get("CKPT_REPLICATE")
    return bool(raw) and raw not in ("0", "false", "False")


def ckpt_async() -> bool:
    """``HVD_TPU_CKPT_ASYNC`` — split checkpointing into *snapshot*
    (device->host at the step barrier) and *persist* (a background thread
    writes the payload and the ``_COMMIT`` manifest).  Default off:
    ``CheckpointManager.save`` commits synchronously."""
    raw = _get("CKPT_ASYNC")
    return bool(raw) and raw not in ("0", "false", "False")


def ckpt_staleness_steps() -> int:
    """``HVD_TPU_CKPT_STALENESS_STEPS`` — bound on the async persist queue:
    a save waits while this many snapshots are still persisting.  0
    (default) leaves the queue unbounded."""
    raw = _get("CKPT_STALENESS_STEPS")
    try:
        return max(0, int(raw)) if raw not in (None, "") else 0
    except ValueError:
        return 0


DEFAULT_TREE_FANOUT = 64
DEFAULT_TREE_THRESHOLD = 256


def tree_enable() -> bool:
    """``HVD_TPU_TREE_ENABLE`` — opt into the hierarchical coordinator tree
    (default off); even then it activates only at :func:`tree_threshold`
    ranks and above."""
    raw = _get("TREE_ENABLE")
    return bool(raw) and raw not in ("0", "false", "False")


def tree_fanout() -> int:
    """``HVD_TPU_TREE_FANOUT`` — worker ranks per aggregator group
    (default 64; values < 2 deactivate the tree)."""
    raw = _get("TREE_FANOUT")
    return int(raw) if raw not in (None, "") else DEFAULT_TREE_FANOUT


def tree_threshold() -> int:
    """``HVD_TPU_TREE_THRESHOLD`` — job size at which an enabled tree
    activates (default 256)."""
    raw = _get("TREE_THRESHOLD")
    return int(raw) if raw not in (None, "") else DEFAULT_TREE_THRESHOLD


DEFAULT_BULK_CHUNK_BYTES = 1 << 20
DEFAULT_BULK_TIMEOUT_MS = 5000.0
DEFAULT_BULK_MAX_BYTES = 1 << 30


def bulk_plane() -> bool:
    """``HVD_TPU_BULK_PLANE`` — the rank-to-rank bulk data plane (default
    ON).  When on, replication shard payloads stream directly between peer
    bulk listeners under coordinator-issued tickets; the coordinator star
    carries only the control frames.  Off: every transfer takes the legacy
    SHARD_PUT relay through rank 0."""
    raw = _get("BULK_PLANE")
    return raw is None or raw not in ("0", "false", "False")


def bulk_chunk_bytes() -> int:
    """``HVD_TPU_BULK_CHUNK_BYTES`` — bulk-stream chunk size (default
    1 MiB); each chunk carries its own CRC32 so corruption is caught at
    chunk granularity."""
    raw = _get("BULK_CHUNK_BYTES")
    try:
        value = int(raw) if raw not in (None, "") else DEFAULT_BULK_CHUNK_BYTES
    except ValueError:
        return DEFAULT_BULK_CHUNK_BYTES
    return max(4096, value)


def bulk_timeout_ms() -> float:
    """``HVD_TPU_BULK_TIMEOUT_MS`` — per-operation socket bound (default
    5000) on the bulk plane: connect, each chunk send/recv, and the final
    ack all share it, so a dead or partitioned peer becomes an abort-and-
    fallback, never a hang."""
    raw = _get("BULK_TIMEOUT_MS")
    try:
        return float(raw) if raw not in (None, "") else DEFAULT_BULK_TIMEOUT_MS
    except ValueError:
        return DEFAULT_BULK_TIMEOUT_MS


def bulk_max_bytes() -> int:
    """``HVD_TPU_BULK_MAX_BYTES`` — ceiling (default 1 GiB) on one bulk
    stream's advertised payload; larger headers are structured errors."""
    raw = _get("BULK_MAX_BYTES")
    try:
        return int(raw) if raw not in (None, "") else DEFAULT_BULK_MAX_BYTES
    except ValueError:
        return DEFAULT_BULK_MAX_BYTES
