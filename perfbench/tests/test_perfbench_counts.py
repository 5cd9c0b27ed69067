"""The yardstick's operation and byte counts against counts made by hand
at small shapes."""

from __future__ import annotations

import pytest

from perfbench import counts

TINY = dict(hidden_size=8, intermediate_size=12, num_attention_heads=2,
            num_key_value_heads=2, num_hidden_layers=3, vocab_size=10)


def test_decoder_parameters_by_hand():
    # a block: q, k, v, o of 8 x 8, gate, up, down of 8 x 12; the head
    # 8 x 10; the embedding 10 x 8; norms 2 a layer and a final one.
    block = 4 * 64 + 3 * 96
    assert counts.decoder_matmul_params(TINY) == 3 * block + 80
    assert counts.decoder_params(TINY) == 3 * block + 80 + 80 + 7 * 8


def test_decoder_flops_per_token_by_hand():
    n = 3 * (4 * 64 + 3 * 96) + 80
    # 6 N, and causal attention: 2 products x 2 ops x S x (H D) / 2, x 3.
    assert counts.decoder_train_flops_per_token(TINY, 16) == \
        6 * n + 6 * 3 * 16 * 8


def test_deepseek_7b_at_eight_layers():
    cfg = dict(hidden_size=4096, intermediate_size=11008,
               num_attention_heads=32, num_key_value_heads=32,
               num_hidden_layers=8, vocab_size=102400)
    assert counts.decoder_params(cfg) == 8 * 202_383_360 + 2 * 419_430_400 \
        + 4096
    assert counts.decoder_train_flops_per_token(cfg, 4096) == \
        pytest.approx(13.036e9, rel=1e-4)


def test_attention_work_by_hand():
    flops, nbytes = counts.attention_train_work(1, 4, 1, 2)
    # six products of 2 x 4 x 4 x 2 = 64 ops over the square, halved.
    assert flops == 6 * 32
    t, lse = 4 * 2 * 2, 4 * 4
    assert nbytes == (3 * t + t + lse) + (5 * t + lse + 3 * t)


def test_roofline_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_resnet_macs_by_hand():
    cfg = dict(stem_filters=2, in_channels=1, stage_sizes=[1, 1],
               expansion=2, num_classes=3)
    # 8 x 8 image: stem 7x7/2 -> 4 x 4 x 2, pool -> 2 x 2.
    stem = 16 * 2 * 1 * 49
    b0 = 4 * 2 * 2 + 4 * 2 * 2 * 9 + 4 * 4 * 2 + 4 * 4 * 2   # proj 2 -> 4
    b1 = 4 * 4 * 4 + 1 * 4 * 4 * 9 + 1 * 8 * 4 + 1 * 8 * 4  # 3x3/2 -> 1x1
    assert counts.resnet_forward_macs(cfg, 8) == stem + b0 + b1 + 8 * 3
    assert counts.resnet_train_flops_per_image(cfg, 8) == \
        2.0 * (3 * (stem + b0 + b1 + 24) - stem)


def test_resnet50_at_224():
    cfg = dict(stem_filters=64, in_channels=3, stage_sizes=[3, 4, 6, 3],
               expansion=4, num_classes=1000)
    assert counts.resnet_forward_macs(cfg, 224) == pytest.approx(
        4.09e9, rel=1e-2)
