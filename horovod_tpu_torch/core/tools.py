"""The native control-plane tools — ``star_bench`` and ``fleet_sim`` of
``core/src``, built by :func:`~horovod_tpu_torch.core._build.build_tool`
(the JAX package builds them with ``make -C horovod_tpu/core``).

* :func:`star_bench` runs the isolated star benchmark: one coordinator and
  ``p - 1`` worker threads over loopback TCP, the real gather and
  broadcast of the engine's tick, ``ticks`` ticks of ``names`` tensor
  names; its result is ``{"p", "ticks", "tick_us", "per_worker_us"}``
  (``examples/control_plane_benchmark.py --star``).
* :func:`fleet_sim` runs the deviceless fleet simulator: the real tree
  root, coordinator and response cache, forked relay aggregators and a
  scripted member mux for ``p`` protocol-only ranks, as a ``tree`` of
  ``fanout`` groups or a ``star``, with ``chaos`` ``kill`` or ``stop`` of
  an aggregator; its result carries ``ok``, ``topology``,
  ``modeled_tick_us``, ``agg_frames_per_tick``, ``mttr_ms`` and
  ``reattaches`` (``tests/test_tree.py``).

Both are host programs: they run no collective on a device.  Each
function builds its tool on first use, runs it, and returns the last JSON
line of its output; a failed run or one without that line raises
:class:`RuntimeError` with the end of the output.
"""

from __future__ import annotations

import json
import subprocess

from horovod_tpu_torch.core import _build


def _run(name: str, args: list[str], key: str, timeout: float) -> dict:
    exe = _build.build_tool(name)
    proc = subprocess.run([exe, *args], capture_output=True, text=True,
                          timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("{") and key in ln]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name} {' '.join(args)} exited "
                           f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def star_bench(p: int, ticks: int = 200, names: int = 1,
               timeout: float = 300.0) -> dict:
    """One star benchmark run at width ``p``."""
    return _run("star_bench", [str(p), str(ticks), str(names)], "tick_us",
                timeout)


def fleet_sim(p: int, ticks: int, *, fanout: int | None = None,
              topology: str | None = None, chaos: str | None = None,
              timeout: float = 300.0) -> dict:
    """One fleet simulation of ``p`` ranks over ``ticks`` ticks."""
    args = ["--p", str(p), "--ticks", str(ticks)]
    for flag, value in (("--fanout", fanout), ("--topology", topology),
                        ("--chaos", chaos)):
        if value is not None:
            args += [flag, str(value)]
    return _run("fleet_sim", args, "modeled_tick_us", timeout)
