"""Kernels of the port, each beside its plain PyTorch version.

Importing the package imports every kernel module, so each registers its
CUDA source with :mod:`horovod_tpu_torch.ops._build`; each is built at its
first launch, or ahead of it by ``_build.KERNELS[name].load()``.
"""

from horovod_tpu_torch.ops import (  # noqa: F401
    decode_attention, flash_attention, rmsnorm)
