"""horovod_tpu_torch.serving — continuous-batching serving on one card.

* ``engine.py``       — ``ServingEngine`` scheduler, ``TransformerBackend``
  (the PyTorch model on its KV cache), ``StubBackend``, ``serving_stats``.
* ``prefix_cache.py`` — refcounted radix-trie KV page bookkeeping.
* ``loadgen.py``      — open-loop Poisson load generator and report.
* ``__main__.py``     — ``python -m horovod_tpu_torch.serving``, one replica.
"""

from __future__ import annotations

from horovod_tpu_torch.serving.engine import (Request, ServingConfig,
                                              ServingEngine, StubBackend,
                                              TransformerBackend,
                                              serving_stats)
from horovod_tpu_torch.serving.prefix_cache import PrefixCache

__all__ = ["PrefixCache", "Request", "ServingConfig", "ServingEngine",
           "StubBackend", "TransformerBackend", "serving_stats"]
