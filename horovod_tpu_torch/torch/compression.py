"""Gradient compression for the torch binding — counterpart of
``horovod_tpu/torch/compression.py``: the port's one registry,
``ops/compression.py`` (reference horovod/torch/compression.py:24-74 in
behaviour).  ``Compression.none`` / ``fp16`` / ``bf16`` cast floating
tensors for the wire and back after; ``Compression.int8`` is the engine's
quantized wire format, which the binding's ops route themselves."""

from __future__ import annotations

from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
