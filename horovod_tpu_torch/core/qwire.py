"""int8 wire payload codec — the port's copy of ``horovod_tpu/core/qwire.py``,
on torch tensors of any device.

One rank's contribution to an int8-wire allreduce is a flat byte payload:

    [f32 scale per tensor ...][int8 values of tensor 0][tensor 1]...

Scales are per tensor, never per payload: one shared scale would zero out a
small-magnitude tensor (a bias gradient) packed next to a large one.  A
non-finite tensor ships q = 0 under its non-finite amax, so the receiver's
dequant-sum gives NaN (inf·0, nan·0) instead of laundering the overflow
into finite values.  Receivers sum every rank's payload in f32, rank by
rank.

The arithmetic is the reference's, step for step, so the two agree bit for
bit: the scale is ``max(amax / 127, tiny)`` formed in float64 and stored
as float32; ``q = clip(round_half_even(a / scale), -127, 127)`` with the
division in float32 by a float32 scale held in a tensor of the device
(PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal,
which rounds differently); the dequant-sum multiplies and adds in two
separate operations (no fused multiply-add).
"""

from __future__ import annotations

import torch

_TINY = float(torch.finfo(torch.float32).tiny)


def quantize_int8(tensors) -> tuple[torch.Tensor, list]:
    """Per-tensor quantization.  Returns ``(scales, qs)``: a float32
    ``[len(tensors)]`` tensor and one flat int8 tensor each; the caller's
    local residual is ``a - scales[t] * qs[t]``."""
    scales, qs = [], []
    for a in tensors:
        f32 = a.detach().reshape(-1).float()
        amax = f32.abs().max() if f32.numel() else f32.new_zeros(())
        finite = torch.isfinite(amax)
        s = torch.clamp(amax.double() / 127.0, min=_TINY).float()
        q = torch.clamp(torch.round(f32 / s), -127, 127)
        qs.append(torch.where(finite, q, torch.zeros_like(q)).to(torch.int8))
        # A NaN amax as the canonical quiet NaN, numpy's, whatever bits
        # the device's max left in it.
        amax = torch.where(torch.isnan(amax), amax.new_tensor(float("nan")),
                           amax)
        scales.append(torch.where(finite, s, amax))
    dev = tensors[0].device if len(tensors) else torch.device("cpu")
    return (torch.stack(scales) if scales
            else torch.zeros(0, dtype=torch.float32, device=dev)), qs


def pack_int8(tensors) -> tuple[torch.Tensor, torch.Tensor, list]:
    """Quantize ``tensors`` into one uint8 payload.  Returns
    ``(payload, scales, qs)``."""
    scales, qs = quantize_int8(tensors)
    payload = torch.cat([scales.view(torch.uint8)]
                        + [q.view(torch.uint8) for q in qs])
    return payload, scales, qs


def unpack_sum_int8(rows: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """Dequant-sum of the gathered payload ``rows`` (``[ranks, bytes]``, one
    per rank) in f32: a flat ``[sum(sizes)]`` tensor, the ranks added in
    rank order."""
    hdr = 4 * len(sizes)
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=rows.device)
    counts = torch.tensor(sizes, device=rows.device)
    for r in range(rows.shape[0]):
        scale = rows[r, :hdr].clone().view(torch.float32)
        data = rows[r, hdr:].view(torch.int8).float()
        acc = acc + data * torch.repeat_interleave(scale, counts)
    return acc
