"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu, for one NVIDIA
H100 (``sm_90a``).

The package mirrors the layout of ``horovod_tpu`` (``ops/``, ``models/``,
``serving/``, ``utils/``) so each module's counterpart is easy to find, and
imports nothing of it: where it needs a JAX-free module of the JAX package,
it keeps its own copy.  Each TPU kernel on a ported path is a kernel written
by hand for Hopper under ``csrc/``, beside a plain PyTorch version with the
same contract; a CUDA tensor launches the kernel, a CPU tensor takes the
plain version.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when asked for CUDA without it.

Ported so far: the serving path of the decoder transformer (forward flash
attention, RMSNorm forward, the model, the continuous-batching engine).
"""

from __future__ import annotations

from horovod_tpu_torch.utils.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
