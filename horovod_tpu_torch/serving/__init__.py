"""horovod_tpu_torch.serving — continuous-batching serving on one card.

* ``engine.py``       — ``ServingEngine`` scheduler, ``TransformerBackend``
  (the PyTorch model on its dense KV cache), ``PagedTransformerBackend``
  (the same model on a KV page pool, with shared-prefix reuse),
  ``StubBackend``, ``serving_stats``.
* ``prefix_cache.py`` — refcounted radix-trie KV page bookkeeping.
* ``router.py``       — multi-model admission and the cross-model replica
  budget (``RouterAutoscaler``).
* ``autoscale.py``    — the queue-depth / p99 replica-count policy.
* ``loadgen.py``      — open-loop Poisson load generator and report.
* ``__main__.py``     — ``python -m horovod_tpu_torch.serving``, one replica.
"""

from __future__ import annotations

from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                              Request, ServingConfig,
                                              ServingEngine, StubBackend,
                                              TransformerBackend,
                                              serving_stats)
from horovod_tpu_torch.serving.prefix_cache import PrefixCache
from horovod_tpu_torch.serving.router import (ModelSpec, Router,
                                              RouterAutoscaler)

__all__ = ["ModelSpec", "PagedTransformerBackend", "PrefixCache",
           "Request", "Router", "RouterAutoscaler", "ServingConfig",
           "ServingEngine", "StubBackend", "TransformerBackend",
           "serving_stats"]
