"""The decoder family (DeepSeek-LLM and any configuration of its shape):
its leaves, its weights made from a seed, and the program's model built
from a configuration file.

The weights are the benchmark's own: :func:`init_flat` draws every
matrix of the model in one call of a ``torch.Generator`` on the device,
in the type they are served in, scaled by the configuration's
``initializer_range``; norm scales are one.  Both the program and the
plain reference take their weights from it, leaf by leaf in the order of
:func:`leaves`, so the same seed gives both sides the same numbers."""

from __future__ import annotations

import torch

from perfbench import counts

NORM = "norm"
MATRIX = "matrix"


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every parameter, matrices as
    ``[out, in]``; the names are the program's ``state_dict`` keys."""
    e, f, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    hd = cfg["num_attention_heads"] * counts.head_dim(cfg)
    kvd = cfg["num_key_value_heads"] * counts.head_dim(cfg)
    out = [("embed.weight", (v, e), MATRIX)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm.scale", (e,), NORM),
                (p + "attn.q.weight", (hd, e), MATRIX),
                (p + "attn.k.weight", (kvd, e), MATRIX),
                (p + "attn.v.weight", (kvd, e), MATRIX),
                (p + "attn.o.weight", (e, hd), MATRIX),
                (p + "mlp_norm.scale", (e,), NORM),
                (p + "mlp.gate.weight", (f, e), MATRIX),
                (p + "mlp.up.weight", (f, e), MATRIX),
                (p + "mlp.down.weight", (e, f), MATRIX)]
    out += [("final_norm.scale", (e,), NORM),
            ("lm_head.weight", (v, e), MATRIX)]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def init_flat(cfg: dict, seed: int, device, dtype=torch.bfloat16):
    """Every matrix of the model, end to end in :func:`leaves`' order, as
    one flat tensor: N(0, 1) from the seed's generator on ``device``,
    times ``initializer_range``, in ``dtype``."""
    n = sum(_numel(s) for _, s, k in leaves(cfg) if k == MATRIX)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    return flat.mul_(cfg["initializer_range"])


def iter_weights(cfg: dict, flat):
    """``(name, tensor)`` of every leaf: views into ``flat`` for the
    matrices, ones for the norm scales (in ``flat``'s dtype)."""
    off = 0
    for name, shape, kind in leaves(cfg):
        if kind == MATRIX:
            n = _numel(shape)
            yield name, flat[off:off + n].view(shape)
            off += n
        else:
            yield name, torch.ones(shape, dtype=flat.dtype,
                                   device=flat.device)


def program_config(cfg: dict, *, train: bool, attention_fn=None):
    """The program's ``TransformerConfig`` for configuration ``cfg``:
    parameters and compute in bf16, the flash-attention and RMSNorm
    kernels on, logits in bf16 for training (the loss widens them) and
    f32 for serving (the engine samples from them)."""
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.ops.flash_attention import make_flash_attention
    from horovod_tpu_torch.ops.rmsnorm import DEFAULT_EPS

    if cfg["rms_norm_eps"] != DEFAULT_EPS or \
            cfg["num_key_value_heads"] != cfg["num_attention_heads"] or \
            cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError("the program's decoder runs RMSNorm at eps "
                         f"{DEFAULT_EPS}, as many KV heads as query heads, "
                         "a SiLU-gated MLP and an untied head")
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], head_dim=counts.head_dim(cfg),
        embed_dim=cfg["hidden_size"], mlp_dim=cfg["intermediate_size"],
        max_seq_len=cfg["max_position_embeddings"], dtype=torch.bfloat16,
        param_dtype=torch.bfloat16,
        attention_fn=attention_fn or make_flash_attention(),
        rope_theta=float(cfg["rope_theta"]),
        logits_dtype=torch.bfloat16 if train else torch.float32,
        fused_norm=True)


def build(cfg: dict, seed: int, device, *, train: bool, attention_fn=None):
    """The program's ``Transformer`` with the seed's weights."""
    from horovod_tpu_torch.models.transformer import Transformer

    tcfg = program_config(cfg, train=train, attention_fn=attention_fn)
    with torch.device(device):
        model = Transformer(tcfg, device=device)
    flat = init_flat(cfg, seed, device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, w in iter_weights(cfg, flat):
            params[name].copy_(w)
    del flat
    return model
