"""Parallelism beyond data parallelism — the port of
``horovod_tpu/parallel/``, so far its sequence (context) parallelism:
ring and zigzag attention over the flash kernels
(``ring_attention.py``), Ulysses all-to-all (``ulysses.py``) and the
planner-driven glue (``context.py``).  Each strategy takes a
``torch.distributed`` process group where the JAX package takes a mesh
axis name.  Tensor, pipeline and expert parallelism, ZeRO and FSDP are
not ported yet.
"""

from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    exchange_stats,
    make_ring_attention,
    make_ring_flash_attention,
    make_zigzag_ring_flash_attention,
    reset_exchange_stats,
    ring_attention,
    ring_flash_attention,
    ring_flash_attention_stats,
    zigzag_inverse_permutation,
    zigzag_permutation,
    zigzag_positions,
    zigzag_ring_flash_attention,
)
from horovod_tpu_torch.parallel.context import (  # noqa: F401
    context_attention_fn,
    context_positions,
    plan_long_context,
    shard_sequence,
    unshard_sequence,
)
from horovod_tpu_torch.parallel.ulysses import (  # noqa: F401
    make_ulysses_attention,
    make_ulysses_flash_attention,
    ulysses_attention,
)
