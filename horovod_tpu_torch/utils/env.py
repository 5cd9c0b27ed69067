"""Environment knobs the port reads: tensor fusion, gradient overlap, the
device headroom and ``HVD_TPU_SERVE_*``.

Own copy of the fusion, overlap, headroom and serving readers of
``horovod_tpu/utils/env.py``, with the same names, defaults and parsing:
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
