"""``python -m horovod_tpu_torch.serving`` — one serving replica on one card.

Builds the 162M decoder (:func:`~horovod_tpu_torch.models.transformer.
config_162m`: flash-attention and RMSNorm kernels on) with seeded random
weights on the device, serves a self-generated open-loop Poisson workload
through the continuous-batching engine, and prints one line
``SERVE_REPORT {...}`` with the load report and the engine's counters.

Knobs, as in the JAX package: ``HVD_TPU_SERVE_BACKEND`` (``transformer``
or ``stub``, the model-free token automaton), ``HVD_TPU_SERVE_QPS``,
``HVD_TPU_SERVE_DURATION_S`` and the scheduler's ``HVD_TPU_SERVE_SLOTS`` /
``_BUCKETS`` / ``_MAX_LEN`` / ``_SPEC_K``.  ``--device`` picks the device
(``cuda`` by default; ``cpu`` runs the plain PyTorch versions).  The fleet
mode of the JAX package (control plane, elastic joins, autoscaling) is
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from horovod_tpu_torch.serving import loadgen
from horovod_tpu_torch.serving.engine import (ServingConfig, ServingEngine,
                                              StubBackend,
                                              TransformerBackend)
from horovod_tpu_torch.utils import env as env_knobs
from horovod_tpu_torch.utils.device import resolve_device


def make_backend(cfg: ServingConfig, device=None, seed: int = 0):
    """The replica's backend: the stub under ``HVD_TPU_SERVE_BACKEND=stub``,
    else the 162M decoder with seeded weights on ``device``.  Returns
    ``(backend, vocab_size)``."""
    if os.environ.get("HVD_TPU_SERVE_BACKEND", "transformer") == "stub":
        return StubBackend(cfg.num_slots), 256
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer, config_162m

    dev = resolve_device(device)
    mcfg = config_162m(max_seq_len=cfg.max_seq_len)
    model = Transformer(mcfg, device=dev)
    model.load_state_dict(init_params(mcfg, seed))
    return TransformerBackend(model, cfg.num_slots, cfg.max_seq_len), \
        mcfg.vocab_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    args = ap.parse_args(argv)
    cfg = ServingConfig.from_env()
    backend, vocab = make_backend(cfg, args.device, args.seed)
    serving = ServingEngine(backend, cfg)
    w = loadgen.Workload(qps=env_knobs.serve_qps(),
                         duration_s=env_knobs.serve_duration_s(),
                         seed=args.seed,
                         prompt_lens=tuple(b - 2 for b in cfg.buckets[:3]),
                         vocab=vocab)
    rep = loadgen.run_load(serving, w, max_wall_s=w.duration_s * 20)
    print("SERVE_REPORT " + json.dumps({**rep, **serving.stats()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
