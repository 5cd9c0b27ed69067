"""Inputs come from the seed alone: the same seed gives the same traffic,
batches and weights, and another seed the same work in another order."""

from __future__ import annotations

import torch

from perfbench.kinds import serve_decoder, train_cnn, train_decoder
from perfbench.models import decoder, resnet
from perfbench.tests import small

BIG = 2 ** 31 + 12345


def test_serving_requests_are_the_seeds():
    _, traffic = small.sizes("deepseek-llm-7b.serve.chat32")
    a = serve_decoder.Requests(traffic, 256, BIG)
    b = serve_decoder.Requests(traffic, 256, BIG)
    c = serve_decoder.Requests(traffic, 256, BIG + 1)
    ta = [a.take() for _ in range(40)]
    assert ta == [b.take() for _ in range(40)]
    tc = [c.take() for _ in range(40)]
    assert ta != tc
    # The same multiset of lengths whatever the seed, in another order.
    n = traffic["requests"]
    la = sorted(a.items[i] for i in a.order[:n])
    assert la == sorted(c.items[i] for i in c.order[:n])
    for p, o in serve_decoder.lengths(traffic):
        assert traffic["prompt"]["min"] <= p <= traffic["prompt"]["max"]
        assert p + o <= traffic["max_seq_len"] and o >= 1


def test_full_size_lengths_fit_the_slots():
    from perfbench import harness

    traffic = harness.traffic("serve.chat32")
    ls = serve_decoder.lengths(traffic)
    assert all(p <= max(traffic["buckets"]) for p, _ in ls)
    assert all(p + o <= traffic["max_seq_len"] for p, o in ls)
    prompts = sorted(p for p, _ in ls)
    assert 800 <= prompts[len(prompts) // 2] <= 1200


def test_training_batches_are_the_seeds():
    cfg, traffic = small.sizes("deepseek-llm-7b.train.s4096")
    dev = torch.device("cpu")
    a = train_decoder.token_pool(cfg, traffic, BIG, dev)
    assert torch.equal(a, train_decoder.token_pool(cfg, traffic, BIG, dev))
    assert not torch.equal(a, train_decoder.token_pool(cfg, traffic,
                                                       BIG + 1, dev))
    rows = a.reshape(-1, a.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    cfg, traffic = small.sizes("resnet50-v1.5.train.b256")
    x, y = train_cnn.image_pool(cfg, traffic, BIG, dev)
    x2, y2 = train_cnn.image_pool(cfg, traffic, BIG, dev)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_weights_are_the_seeds():
    cfg, _ = small.sizes("deepseek-llm-7b.train.s4096")
    dev = torch.device("cpu")
    a = decoder.init_flat(cfg, BIG, dev)
    assert torch.equal(a, decoder.init_flat(cfg, BIG, dev))
    assert a.dtype == torch.bfloat16
    assert abs(float(a.float().std()) - cfg["initializer_range"]) < 2e-3
    names = [n for n, _ in decoder.iter_weights(cfg, a)]
    assert names == [n for n, _, _ in decoder.leaves(cfg)]
    cfg, _ = small.sizes("resnet50-v1.5.train.b256")
    w = dict(resnet.iter_weights(cfg, resnet.init_flat(cfg, BIG, dev)))
    conv = w["blocks.0.convs.1.weight"]
    fan_out = conv.shape[0] * 9
    assert abs(float(conv.std()) - (2 / fan_out) ** 0.5) < 0.1 * \
        (2 / fan_out) ** 0.5


def test_program_takes_the_leaves():
    """The program's models hold exactly the configuration's leaves, so
    the reference and the program start from the same numbers."""
    dev = torch.device("cpu")
    cfg, _ = small.sizes("deepseek-llm-7b.train.s4096")
    model = decoder.build(cfg, BIG, dev, train=True)
    flat = decoder.init_flat(cfg, BIG, dev)
    params = dict(model.named_parameters())
    for n, w in decoder.iter_weights(cfg, flat):
        assert torch.equal(params[n], w)
    cfg, _ = small.sizes("resnet50-v1.5.train.b256")
    model = resnet.build(cfg, BIG, dev)
    params = dict(model.named_parameters())
    for n, w in resnet.iter_weights(cfg, resnet.init_flat(cfg, BIG, dev)):
        assert torch.equal(params[n], w)
