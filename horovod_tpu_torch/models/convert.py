"""Carry the JAX package's transformer weights into the PyTorch model.

The flax model (``horovod_tpu/models/transformer.py``) stores its
parameters as a nested dict of arrays; the port's :class:`Transformer`
holds the same numbers as an ``nn.Module`` ``state_dict``.  The layouts
differ in three places:

* ``DenseGeneral`` q/k/v kernels are ``[E, H, D]`` and the output
  projection ``o`` is ``[H, D, E]``; the port's projections are plain
  ``nn.Linear`` layers over the flattened ``H * D`` axis;
* ``Dense`` kernels are ``[in, out]``, the transpose of an ``nn.Linear``
  weight;
* the embedding table (``[V, E]``) and the norm ``scale`` vectors carry
  over as they are.

:func:`init_params` makes seeded random weights in the flax layout with
numpy and converts them the same way, so a model built on the card from a
seed is one the JAX package could have built too.
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.models.transformer import TransformerConfig


def params_from_flax(tree, cfg: TransformerConfig) -> dict:
    """Flax parameter tree (numpy leaves, with or without the top-level
    ``"params"`` key) -> ``state_dict`` of CPU tensors in
    ``cfg.param_dtype`` for :class:`Transformer`."""
    p = tree.get("params", tree)
    e, hd = cfg.embed_dim, cfg.num_heads * cfg.head_dim

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32).to(
            cfg.param_dtype)

    def kernel(tree, shape=None):
        """A flax kernel as an ``nn.Linear`` weight: ``[in, out]`` (or
        ``shape``, flattened to it) transposed to ``[out, in]``."""
        a = np.asarray(tree["kernel"])
        return t((a if shape is None else a.reshape(shape)).T)

    sd = {"embed.weight": t(p["embed"]["embedding"]),
          "final_norm.scale": t(p["final_norm"]["scale"]),
          "lm_head.weight": kernel(p["lm_head"])}
    for i in range(cfg.num_layers):
        lp, pre = p[f"layer_{i}"], f"layers.{i}."
        attn = lp["attn"]
        for name in ("q", "k", "v"):
            sd[f"{pre}attn.{name}.weight"] = kernel(attn[name], (e, hd))
        sd[f"{pre}attn.o.weight"] = kernel(attn["o"], (hd, e))
        for name in ("gate", "up", "down"):
            sd[f"{pre}mlp.{name}.weight"] = kernel(lp["mlp"][name])
        sd[f"{pre}attn_norm.scale"] = t(lp["attn_norm"]["scale"])
        sd[f"{pre}mlp_norm.scale"] = t(lp["mlp_norm"]["scale"])
    return sd


def flax_tree(cfg: TransformerConfig, seed: int) -> dict:
    """Seeded random weights in the flax layout (numpy float32): every
    kernel ``N(0, 1/fan_in)``, the embedding ``N(0, 1)``, norm scales 1."""
    rng = np.random.default_rng(seed)
    e, h, d, f = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim

    def dense(*shape, fan_in):
        return (rng.standard_normal(shape, np.float32)
                / np.float32(np.sqrt(fan_in)))

    ones = lambda: {"scale": np.ones(e, np.float32)}  # noqa: E731
    p = {"embed": {"embedding": rng.standard_normal((cfg.vocab_size, e),
                                                    np.float32)},
         "final_norm": ones(),
         "lm_head": {"kernel": dense(e, cfg.vocab_size, fan_in=e)}}
    for i in range(cfg.num_layers):
        p[f"layer_{i}"] = {
            "attn_norm": ones(), "mlp_norm": ones(),
            "attn": {"q": {"kernel": dense(e, h, d, fan_in=e)},
                     "k": {"kernel": dense(e, h, d, fan_in=e)},
                     "v": {"kernel": dense(e, h, d, fan_in=e)},
                     "o": {"kernel": dense(h, d, e, fan_in=h * d)}},
            "mlp": {"gate": {"kernel": dense(e, f, fan_in=e)},
                    "up": {"kernel": dense(e, f, fan_in=e)},
                    "down": {"kernel": dense(f, e, fan_in=f)}}}
    return {"params": p}


def init_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Seeded random ``state_dict`` for :class:`Transformer` (CPU
    tensors; ``load_state_dict`` copies them to the model's device)."""
    return params_from_flax(flax_tree(cfg, seed), cfg)
