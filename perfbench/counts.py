"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work each metric divides by, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its full power limit of 700 W; ``PERF.md`` gives the limit the card read
beside every number."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def decoder_matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product per token: every block's
    projections and MLP, and the head; not the embedding (a lookup) and
    not the norms' scales."""
    e, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg["num_attention_heads"] * head_dim(cfg)
    kvd = cfg["num_key_value_heads"] * head_dim(cfg)
    block = e * hd + 2 * e * kvd + hd * e + 3 * e * f
    return cfg["num_hidden_layers"] * block + e * cfg["vocab_size"]


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or \
        cfg["hidden_size"] // cfg["num_attention_heads"]


def decoder_params(cfg: dict) -> int:
    """Every parameter of the decoder, embedding and norms included."""
    e = cfg["hidden_size"]
    return decoder_matmul_params(cfg) + e * cfg["vocab_size"] + \
        (2 * cfg["num_hidden_layers"] + 1) * e


def decoder_train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Training operations a token: ``6·N`` over the matrix-product
    parameters and ``6·L·S·E`` for causal attention (the score and value
    products, half of the square, three passes); nothing recomputed."""
    return 6 * decoder_matmul_params(cfg) + \
        6 * cfg["num_hidden_layers"] * seq_len * \
        cfg["num_attention_heads"] * head_dim(cfg)


def attention_train_work(batch: int, seq: int, heads: int, dim: int,
                         elem_bytes: int = 2) -> tuple[float, float]:
    """``(operations, bytes)`` of one layer's causal attention in a
    training step, forward and backward.

    Operations: the forward's two products (scores, values) and the
    backward's four (dV, dP, dQ, dK), each ``2·B·H·S²·D`` over the full
    square, halved for the causal mask; the backward's recomputation of
    the scores is not counted.  Bytes: each input read once and each
    output written once: forward q, k, v in, out and the f32 log-sum-exp
    out; backward q, k, v, out, dout and the log-sum-exp in, dq, dk, dv
    out."""
    mm = 2.0 * batch * heads * seq * seq * dim / 2
    flops = 6 * mm
    t = batch * seq * heads * dim * elem_bytes
    lse = batch * seq * heads * 4
    fwd = 3 * t + t + lse
    bwd = 5 * t + lse + 3 * t
    return flops, float(fwd + bwd)


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_BF16_FLOPS,
                  peak_bytes: float = PEAK_HBM_BYTES) -> float:
    """The roofline: the larger of the compute and the memory bound."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def conv_out(size: int, stride: int) -> int:
    """Output positions of a "SAME" window: ``ceil(size / stride)``."""
    return -(-size // stride)


def resnet_stem_macs(cfg: dict, image: int) -> int:
    s = conv_out(image, 2)
    return s * s * cfg["stem_filters"] * cfg["in_channels"] * 7 * 7


def resnet_forward_macs(cfg: dict, image: int) -> int:
    """Multiply-adds of one image's forward pass through a bottleneck
    ResNet: every convolution (``H_out·W_out·C_out·C_in·k²``) and the
    fully connected head; batch norm, ReLU, pooling and the residual adds
    are not products and are left out."""
    stem = cfg["stem_filters"]
    macs = resnet_stem_macs(cfg, image)
    s = conv_out(conv_out(image, 2), 2)         # after the 3x3/2 max pool
    in_ch = stem
    for i, count in enumerate(cfg["stage_sizes"]):
        filters = stem * 2 ** i
        out = filters * cfg["expansion"]
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            macs += s * s * filters * in_ch                 # 1x1
            s2 = conv_out(s, stride)
            macs += s2 * s2 * filters * filters * 9         # 3x3, strided
            macs += s2 * s2 * out * filters                 # 1x1
            if in_ch != out or stride != 1:
                macs += s2 * s2 * out * in_ch               # projection
            s, in_ch = s2, out
    macs += in_ch * cfg["num_classes"]
    return macs


def resnet_train_flops_per_image(cfg: dict, image: int) -> float:
    """Training operations an image: the forward's products, their weight
    gradients, and their data gradients but the stem's (the images need
    none); two operations a multiply-add."""
    fwd = resnet_forward_macs(cfg, image)
    return 2.0 * (3 * fwd - resnet_stem_macs(cfg, image))
