"""RMSNorm: the CUDA kernels ``csrc/rmsnorm_fwd.cu`` and
``csrc/rmsnorm_bwd.cu``, each beside its plain PyTorch version, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``horovod_tpu/ops/rmsnorm.py``:
``y = x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, statistics in
f32, ``y`` in x's dtype.  The backward recomputes the rsqrt from x (only
``x`` and ``scale`` are saved), gives ``dx`` in x's dtype and ``dscale`` in
scale's.  A CUDA tensor launches the kernels (float32 or bfloat16 ``x``;
the scale goes to them as float32) or raises; a CPU tensor takes
:func:`rms_norm_reference` and :func:`rms_norm_backward_reference`.

Each call is one launch, at any width.  Both kernels hold rows of up to
2 KB in registers, 16-byte vectors a lane (the bf16 width 768 of every
path); other widths and unaligned tensors take each kernel's loop form,
chosen by shape in the kernel's entry point.  The backward's rows past
:data:`WIDE_BWD_WIDTH` take its wide form, a block per row with one row of
dscale partials (in shared memory, or past 57856 in the partials scratch).  The forward's rows do not depend on N: a row
has the same bits alone, in a decode batch or in a training step
(``csrc/rmsnorm_fwd.cu``).  The backward sums its per-block dscale partials
itself, in block order, so the wrapper sums nothing.  The last block to
finish is found with ticket counters that live in a small zeroed workspace,
allocated once per (device, stream) and left zeroed by every launch
(``csrc/rmsnorm_bwd.cu``).

The JAX package leaves the kernels off by default because XLA fuses the
plain norm into its neighbours on the TPU.  Eager PyTorch fuses nothing, so
on the card the kernels are the one-pass versions of the norm.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from horovod_tpu_torch.ops import _build

DEFAULT_EPS = 1e-6
# The backward kernel's grid cap: each block writes one [E] row of dscale
# partials, so this bounds the scratch the kernel sums.
MAX_BWD_BLOCKS = 256
# Rows in flight per block of the backward: a row a warp, and a row a block
# in the wide form that rows past this width take (csrc/rmsnorm_bwd.cu,
# kMaxWarpRowsE), so the grid spreads the same rows over more blocks there.
WIDE_BWD_WIDTH = 7168
# Ticket counters of the backward's cross-block sum: it needs
# 1 + ceil(blocks / 16) <= 17 of them, and checks the count it is given.
BWD_COUNTERS = 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = _build.register(
    "rmsnorm_fwd", "hvd_rmsnorm_fwd", [_P, _P, _P, _I, _I, _I, _F, _P])
BWD_KERNEL = _build.register(
    "rmsnorm_bwd", "hvd_rmsnorm_bwd", [_P] * 7 + [_I, _I, _I, _I, _F, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WORKSPACES: dict = {}


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def rms_norm_reference(x, scale, eps: float = DEFAULT_EPS):
    """Plain PyTorch RMSNorm: f32 statistics, output in x's dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def rms_norm_backward_reference(x, scale, dy, eps: float = DEFAULT_EPS):
    """Plain PyTorch version of the backward kernel: ``(dx, dscale)`` with
    ``dx = r·(g − x̂·mean(g·x̂))``, ``g = dy·scale``, in x's dtype, and
    ``dscale = Σ dy·x̂`` over every leading axis, in scale's dtype."""
    xf, dyf = x.float(), dy.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    g = dyf * scale.float()
    dx = inv * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _check_cuda_inputs(x, scale):
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm: CUDA kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if scale.shape != x.shape[-1:] or scale.device != x.device:
        raise ValueError(f"rms_norm: scale must be [{x.shape[-1]}] on "
                         f"{x.device}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous")


def _bwd_workspace(device, stream) -> torch.Tensor:
    """The backward kernel's ticket counters on ``stream``: zeroed once,
    and zero again after every launch, so launches on one stream share
    them; launches on two streams could overlap, so each has its own."""
    key = (device, getattr(stream, "value", stream))
    if key not in _WORKSPACES:
        _WORKSPACES[key] = torch.zeros(BWD_COUNTERS, dtype=torch.int32,
                                       device=device)
    return _WORKSPACES[key]


def _rms_norm_cuda(x, scale, eps):
    _check_cuda_inputs(x, scale)
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


def _rms_norm_bwd_cuda(x, scale, dy, eps):
    _check_cuda_inputs(x, scale)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rms_norm backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    e = x.shape[-1]
    n = x.numel() // e if e else 0
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(scale)
    rows_per_block = 1 if e > WIDE_BWD_WIDTH else 8
    # Set from N and E alone, so the order of every sum is too.
    blocks = min(-(-n // rows_per_block), MAX_BWD_BLOCKS)
    part = torch.empty((blocks, e), dtype=torch.float32, device=x.device)
    dscale = torch.empty(e, dtype=torch.float32, device=x.device)
    scale32 = scale.to(torch.float32).contiguous()
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        counters = _bwd_workspace(x.device, stream)
        BWD_KERNEL(x.data_ptr(), dy.data_ptr(), scale32.data_ptr(),
                   dx.data_ptr(), part.data_ptr(), dscale.data_ptr(),
                   counters.data_ptr(), counters.numel(), _DTYPES[x.dtype],
                   n, e, eps, blocks, stream)
    # The kernel summed its per-block partials, as the JAX caller sums its
    # kernel's (rmsnorm.py:139).
    return dx, dscale.to(scale.dtype)


def rms_norm_backward(x, scale, dy, eps: float = DEFAULT_EPS):
    """``(dx, dscale)`` of :func:`rms_norm` at ``x`` for the output
    gradient ``dy``."""
    if _on_cuda(x):
        return _rms_norm_bwd_cuda(x, scale, dy, eps)
    return rms_norm_backward_reference(x, scale, dy, eps)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with its fused backward, as the JAX package's custom VJP:
    the forward saves only ``(x, scale)``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if _on_cuda(x):
            return _rms_norm_cuda(x, scale, eps)
        return rms_norm_reference(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rms_norm(x, scale, eps: float = DEFAULT_EPS):
    """RMSNorm over the last axis.  ``x``: ``[..., E]``; ``scale``: ``[E]``.
    Differentiable in both."""
    return _RMSNorm.apply(x, scale, eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm module with one ``scale`` parameter, as the JAX package's
    ``FusedRMSNorm``: casts x to ``dtype`` first, then runs the kernels
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
