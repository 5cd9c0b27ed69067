"""Checkpoint-manifest protocol — the port's copy of
``horovod_tpu/utils/manifest.py``, with the same on-disk format, so a
checkpoint directory written by either package reads the same through
both.

A *complete* checkpoint is a ``step_<N>`` directory containing a
``_COMMIT`` manifest, written strictly AFTER the state payload has been
durably staged.  Readers (the launcher's restart supervision in run.py
and ``checkpoint.CheckpointManager``) only ever consider committed
steps, so a rank killed mid-write can never poison resume: the torn
directory simply has no manifest and is skipped (and later cleaned).

Standard library only: the launcher parent process resolves "newest
complete checkpoint" through it without importing torch for every restart
attempt.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

COMMIT_FILE = "_COMMIT"
STEP_PREFIX = "step_"


def step_dir(root: str | os.PathLike, step: int) -> str:
    return os.path.join(os.fspath(root), f"{STEP_PREFIX}{step}")


def parse_step(name: str) -> int | None:
    """``step_<N>`` -> N, else None (foreign entries are ignored)."""
    if not name.startswith(STEP_PREFIX):
        return None
    try:
        return int(name[len(STEP_PREFIX):])
    except ValueError:
        return None


def is_complete(path: str | os.PathLike) -> bool:
    """True only when the manifest PARSES, not merely exists: a torn
    ``_COMMIT`` (filesystem tearing the write, injected via
    ``HVD_TPU_FAULT_TORN_MANIFEST_STEP``) must read as incomplete."""
    return read_commit(path) is not None


def write_commit(path: str | os.PathLike, step: int,
                 metadata: dict[str, Any] | None = None) -> None:
    """Atomically publish the commit manifest for a staged checkpoint.

    Write-to-temp + rename within the same directory, so a reader never
    observes a partial manifest (``checkpoint.save`` writes the payload
    the same way).
    """
    path = os.fspath(path)
    doc = {"step": int(step), "metadata": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".commit.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, COMMIT_FILE))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_commit(path: str | os.PathLike) -> dict[str, Any] | None:
    """Parse the commit manifest, or None when absent/unreadable."""
    try:
        with open(os.path.join(os.fspath(path), COMMIT_FILE)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def complete_steps(root: str | os.PathLike) -> list[int]:
    """All committed step numbers under ``root``, ascending."""
    root = os.fspath(root)
    if not os.path.isdir(root):
        return []
    steps = []
    for entry in os.listdir(root):
        step = parse_step(entry)
        if step is not None and is_complete(os.path.join(root, entry)):
            steps.append(step)
    return sorted(steps)


def latest_complete(root: str | os.PathLike) -> tuple[int, str] | None:
    """(step, path) of the newest committed checkpoint, or None."""
    steps = complete_steps(root)
    if not steps:
        return None
    return steps[-1], step_dir(root, steps[-1])
