"""``HVD_TPU_SERVE_*`` environment knobs the serving port reads.

Own copy of the serving readers of ``horovod_tpu/utils/env.py``, with the
same names, defaults and parsing: each knob is looked up as
``HOROVOD_<name>`` first, then ``HVD_TPU_<name>``; unset gives the
default, and a malformed value gives the default with a warning — a bad
knob never takes a serving replica down.
"""

from __future__ import annotations

import os
import warnings

DEFAULT_BUCKETS = (16, 32, 64, 128)


def _get(name: str, default: str | None = None) -> str | None:
    return os.environ.get("HOROVOD_" + name,
                          os.environ.get("HVD_TPU_" + name, default))


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


def serve_qps() -> float:
    """``HVD_TPU_SERVE_QPS`` — Poisson arrival rate of the self-driven
    workload (default 20)."""
    return _serve_number("SERVE_QPS", 20.0, float, floor=0.001)


def serve_duration_s() -> float:
    """``HVD_TPU_SERVE_DURATION_S`` — workload duration (default 3)."""
    return _serve_number("SERVE_DURATION_S", 3.0, float, floor=0.01)
