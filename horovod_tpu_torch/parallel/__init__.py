"""Parallelism beyond data parallelism — the port of
``horovod_tpu/parallel/``:

* sequence (context) parallelism — ring and zigzag attention over the
  flash kernels (``ring_attention.py``), Ulysses all-to-all
  (``ulysses.py``) and the planner-driven glue (``context.py``);
* tensor parallelism — Megatron column / row layers
  (``tensor_parallel.py``);
* pipeline parallelism — GPipe, one stage a rank (``pipeline.py``);
* expert parallelism — switch-MoE over all-to-all (``expert.py``);
* optimizer-state sharding — ZeRO-1 (``zero.py``);
* full parameter sharding — FSDP / ZeRO-3 (``fsdp.py``);
* the reference's two-tier allreduce (``hierarchy.py``).

Each strategy takes a ``torch.distributed`` process group where the JAX
package takes a mesh axis name; ``common.py`` holds the collectives they
share.
"""

from horovod_tpu_torch.parallel.common import (  # noqa: F401
    collective_stats,
    reset_collective_stats,
    shard_init_rng,
)
from horovod_tpu_torch.parallel.hierarchy import (  # noqa: F401
    hierarchical_allreduce,
)
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
from horovod_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    ColumnParallelDense,
    ParallelMLP,
    RowParallelDense,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    stage_init_rng,
)
from horovod_tpu_torch.parallel.expert import (  # noqa: F401
    expert_init_rng,
    expert_parallel_moe,
    moe_grad_sync,
    moe_stats,
    reset_moe_stats,
    switch_route,
)
from horovod_tpu_torch.parallel.zero import zero_optimizer  # noqa: F401
from horovod_tpu_torch.parallel.fsdp import (  # noqa: F401
    fsdp_device_put,
    fsdp_shardings,
    fsdp_spec,
)
