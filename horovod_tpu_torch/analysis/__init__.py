"""Correctness tooling for the collective contract — the port of
``horovod_tpu/analysis/``.

Every rank must issue the same collectives in the same program order, and
nothing in the runtime can *prevent* a violation: the stall detector
(core/src/controller.cc) only reports the resulting hang.  This package
closes the gap from three ends:

* :mod:`horovod_tpu_torch.analysis.lint` — ``hvd-lint``, an AST-based
  static analyzer (``python -m horovod_tpu_torch.analysis.lint <paths>``)
  that rejects rank-divergent collective call sites (``torch.distributed``
  spellings included), unnamed collectives in loops, nondeterministically
  named collectives, host randomness in captured steps and process groups
  not created by every process in one order, before a job ever launches
  (``--list-rules`` prints the catalog);
* :mod:`horovod_tpu_torch.analysis.protocol` — the explicit-state model
  checker of the control-plane protocol, whose wire mirror is pinned to the
  port's own native encoder;
* :mod:`horovod_tpu_torch.analysis.schedule` — the runtime schedule
  verifier: under ``HVD_TPU_VERIFY_SCHEDULE=1`` every submitted collective
  extends a per-rank rolling hash that the native coordinator cross-checks
  across ranks, turning a divergent schedule into a coordinated abort with
  a structured report (``divergence_report()``).

``python -m horovod_tpu_torch.core.check`` runs the linter and the model
checker as legs of the port's pre-PR gate.
"""

import importlib

# Lazy (PEP 562): `python -m horovod_tpu_torch.analysis.lint` must not
# import the lint module twice (runpy warns), and importing the package must
# stay stdlib-cheap.
_ATTR_HOME = {
    "LintError": "horovod_tpu_torch.analysis.lint",
    "lint_paths": "horovod_tpu_torch.analysis.lint",
    "lint_source": "horovod_tpu_torch.analysis.lint",
    "divergence_report": "horovod_tpu_torch.analysis.schedule",
    "verify_enabled": "horovod_tpu_torch.analysis.schedule",
    "verify_interval_ticks": "horovod_tpu_torch.analysis.schedule",
}

__all__ = sorted(_ATTR_HOME)


def __getattr__(name: str):
    home = _ATTR_HOME.get(name)
    if home is None:
        raise AttributeError(
            f"module 'horovod_tpu_torch.analysis' has no attribute {name!r}")
    value = getattr(importlib.import_module(home), name)
    globals()[name] = value
    return value
