"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm_fwd.cu`` and its plain
PyTorch version.

Counterpart of ``horovod_tpu/ops/rmsnorm.py`` (forward only):
``y = x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, statistics in
f32, ``y`` in x's dtype.  A CUDA tensor launches the kernel (float32 or
bfloat16 ``x``; the scale goes to the kernel as float32) or raises; a CPU
tensor takes :func:`rms_norm_reference`.  The backward is not ported yet,
so the CUDA path raises when autograd would record it.

The JAX package leaves the kernel off by default because XLA fuses the
plain norm into its neighbours on the TPU.  Eager PyTorch fuses nothing, so
on the card the kernel is the one-pass version of the norm.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from horovod_tpu_torch.ops import _build

DEFAULT_EPS = 1e-6

KERNEL = _build.register(
    "rmsnorm_fwd", "hvd_rmsnorm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def rms_norm_reference(x, scale, eps: float = DEFAULT_EPS):
    """Plain PyTorch RMSNorm: f32 statistics, output in x's dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def _rms_norm_cuda(x, scale, eps):
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError("rms_norm: the backward kernel is not ported yet; "
                           "call under torch.no_grad() or "
                           "torch.inference_mode()")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm: CUDA kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if scale.shape != x.shape[-1:] or scale.device != x.device:
        raise ValueError(f"rms_norm: scale must be [{x.shape[-1]}] on "
                         f"{x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous")
    e = x.shape[-1]
    n = x.numel() // e if e else 0
    y = torch.empty_like(x)
    if n == 0:
        return y
    scale32 = scale.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        KERNEL(x.data_ptr(), scale32.data_ptr(), y.data_ptr(),
               _DTYPES[x.dtype], n, e, eps, _build.stream_of(x))
    return y


def rms_norm(x, scale, eps: float = DEFAULT_EPS):
    """RMSNorm over the last axis.  ``x``: ``[..., E]``; ``scale``: ``[E]``."""
    if _on_cuda(x):
        return _rms_norm_cuda(x, scale, eps)
    return rms_norm_reference(x, scale, eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm module with one ``scale`` parameter, as the JAX package's
    ``FusedRMSNorm``: casts x to ``dtype`` first, then runs the kernel
    (``use_fused=True``) or the plain version."""

    def __init__(self, dim: int, dtype=torch.float32,
                 param_dtype=torch.float32, epsilon: float = DEFAULT_EPS,
                 use_fused: bool | None = None, device=None):
        super().__init__()
        self.dtype, self.epsilon, self.use_fused = dtype, epsilon, use_fused
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        x = x.to(self.dtype)
        if self.use_fused:
            return rms_norm(x, self.scale, self.epsilon)
        return rms_norm_reference(x, self.scale, self.epsilon)
