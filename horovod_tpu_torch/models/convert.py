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
  over as they are, and so do a switch-MoE block's ``moe_mlp`` (its
  ``router`` and its expert's ``gate``, ``up`` and ``down``, float32 and
  ``[in, out]`` in both packages).

A pipeline stage holds a run of the blocks: :func:`stage_state_dict`
renumbers them from 0.

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
    ``cfg.param_dtype`` for :class:`Transformer`.

    Leaves may be float32 or bfloat16 (a flax model made with
    ``param_dtype=jnp.bfloat16`` has ``ml_dtypes.bfloat16`` leaves, which
    torch cannot read): each is widened to float32 first, which is exact,
    so a bf16 tree lands on the same bf16 values."""
    p = tree.get("params", tree)
    e, hd = cfg.embed_dim, cfg.num_heads * cfg.head_dim

    def t(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(np.float32))).to(
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
        if "moe_mlp" in lp:
            for name in ("router", "gate", "up", "down"):
                sd[f"{pre}moe_mlp.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(
                        lp["moe_mlp"][name]).astype(np.float32)))
        else:
            for name in ("gate", "up", "down"):
                sd[f"{pre}mlp.{name}.weight"] = kernel(lp["mlp"][name])
        sd[f"{pre}attn_norm.scale"] = t(lp["attn_norm"]["scale"])
        sd[f"{pre}mlp_norm.scale"] = t(lp["mlp_norm"]["scale"])
    return sd


def flax_tree(cfg: TransformerConfig, seed: int, n_experts: int = 0,
              expert: int = 0) -> dict:
    """Seeded random weights in the flax layout (numpy float32): every
    kernel ``N(0, 1/fan_in)``, the embedding ``N(0, 1)``, norm scales 1.
    With ``n_experts`` each block has a ``moe_mlp`` in place of its
    ``mlp``: the router drawn alike for every expert, the expert's weights
    from a generator of its own (``expert``)."""
    rng = np.random.default_rng(seed)
    erng = np.random.default_rng([seed, expert + 1])
    e, h, d, f = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim

    def dense(*shape, fan_in, gen=rng):
        return (gen.standard_normal(shape, np.float32)
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
                     "o": {"kernel": dense(h, d, e, fan_in=h * d)}}}
        if n_experts:
            p[f"layer_{i}"]["moe_mlp"] = {
                "router": dense(e, n_experts, fan_in=e),
                "gate": dense(e, f, fan_in=e, gen=erng),
                "up": dense(e, f, fan_in=e, gen=erng),
                "down": dense(f, e, fan_in=f, gen=erng)}
        else:
            p[f"layer_{i}"]["mlp"] = {
                "gate": {"kernel": dense(e, f, fan_in=e)},
                "up": {"kernel": dense(e, f, fan_in=e)},
                "down": {"kernel": dense(f, e, fan_in=f)}}
    return {"params": p}


def init_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Seeded random ``state_dict`` for :class:`Transformer` (CPU
    tensors; ``load_state_dict`` copies them to the model's device).
    Under ``cfg.moe_axis`` the experts are this rank's of that group."""
    n_experts = expert = 0
    if cfg.moe_axis is not None:
        import torch.distributed as dist

        n_experts = dist.get_world_size(cfg.moe_axis)
        expert = dist.get_rank(cfg.moe_axis)
    return params_from_flax(flax_tree(cfg, seed, n_experts, expert), cfg)


def stage_state_dict(state_dict: dict, first: int, count: int) -> dict:
    """A pipeline stage's share of a whole model's ``state_dict``: blocks
    ``first .. first + count - 1`` renumbered from 0, and every tensor
    outside the blocks (embedding, final norm, head)."""
    out = {}
    for name, t in state_dict.items():
        if not name.startswith("layers."):
            out[name] = t
            continue
        _, i, rest = name.split(".", 2)
        if first <= int(i) < first + count:
            out[f"layers.{int(i) - first}.{rest}"] = t
    return out


# -- The CNNs: ResNet, VGG, Inception V3 and the MNIST models ----------------
#
# The flax models (``horovod_tpu/models/{resnet,vgg,inception,mnist}.py``)
# keep ``params`` and ``batch_stats`` as nested dicts; the port's models hold
# the same numbers in a ``state_dict``.  Conv kernels are HWIO in flax and
# OIHW here, Dense kernels ``[in, out]`` and ``[out, in]``; BatchNorm
# ``scale``, ``bias``, ``mean`` and ``var`` carry over as they are.


def _flax_layout(model) -> list[tuple[str, str, tuple, str]]:
    """``(state_dict name, flax collection, flax path, kind)`` for every
    tensor of a port :class:`~.resnet.ResNet`, :class:`~.vgg.VGG`,
    :class:`~.inception.InceptionV3`, :class:`~.mnist.MnistCNN` or
    :class:`~.mnist.MnistMLP`; kind is ``conv``, ``dense`` or ``vec``.
    flax names the modules a ``compact`` method makes after their class
    and creation order (``Conv_3``, ``InceptionC_0``), which is the order
    the port's lists hold them in."""
    from horovod_tpu_torch.models import inception, mnist, resnet, vgg

    out = []

    def conv(name, path, bias=False):
        out.append((f"{name}.weight", "params", path + ("kernel",), "conv"))
        if bias:
            out.append((f"{name}.bias", "params", path + ("bias",), "vec"))

    def norm(name, path):
        for p in ("scale", "bias"):
            out.append((f"{name}.{p}", "params", path + (p,), "vec"))
        for s in ("mean", "var"):
            out.append((f"{name}.{s}", "batch_stats", path + (s,), "vec"))

    def dense(name, path):
        out.append((f"{name}.weight", "params", path + ("kernel",), "dense"))
        out.append((f"{name}.bias", "params", path + ("bias",), "vec"))

    if isinstance(model, resnet.ResNet):
        conv("conv_init", ("conv_init",))
        norm("bn_init", ("bn_init",))
        for i, block in enumerate(model.blocks):
            pre, path = f"blocks.{i}", (f"{type(block).__name__}_{i}",)
            for j in range(len(block.convs)):
                conv(f"{pre}.convs.{j}", path + (f"Conv_{j}",))
                norm(f"{pre}.norms.{j}", path + (f"BatchNorm_{j}",))
            if block.conv_proj is not None:
                conv(f"{pre}.conv_proj", path + ("conv_proj",))
                norm(f"{pre}.norm_proj", path + ("norm_proj",))
        dense("head", ("head",))
    elif isinstance(model, vgg.VGG):
        for j in range(len(model.convs)):
            conv(f"convs.{j}", (f"Conv_{j}",), bias=not model.batch_norm)
            if model.batch_norm:
                norm(f"norms.{j}", (f"BatchNorm_{j}",))
        for j in range(len(model.dense)):
            dense(f"dense.{j}", (f"Dense_{j}",))
        dense("head", ("head",))
    elif isinstance(model, inception.InceptionV3):
        top = list(model.stem) + list(model.aux or ())
        for j, unit in enumerate(top):
            name = f"stem.{j}" if j < len(model.stem) else \
                f"aux.{j - len(model.stem)}"
            conv(f"{name}.conv", (f"Conv_{j}",))
            norm(f"{name}.norm", (f"BatchNorm_{j}",))
        seen: dict = {}
        for i, block in enumerate(model.blocks):
            kind = type(block).__name__
            path = (f"{kind}_{seen.get(kind, 0)}",)
            seen[kind] = seen.get(kind, 0) + 1
            for j in range(len(block.units)):
                conv(f"blocks.{i}.units.{j}.conv", path + (f"Conv_{j}",))
                norm(f"blocks.{i}.units.{j}.norm",
                     path + (f"BatchNorm_{j}",))
        if model.aux_head is not None:
            dense("aux_head", ("aux_head",))
        dense("head", ("head",))
    elif isinstance(model, mnist.MnistCNN):
        for j in range(len(model.convs)):
            conv(f"convs.{j}", (f"Conv_{j}",), bias=True)
        for j in range(len(model.dense)):
            dense(f"dense.{j}", (f"Dense_{j}",))
    elif isinstance(model, mnist.MnistMLP):
        for j in range(len(model.dense)):
            dense(f"dense.{j}", (f"Dense_{j}",))
    else:
        raise TypeError(f"no flax layout for {type(model).__name__}")
    return out


def _to_torch(a, kind):
    a = np.asarray(a, dtype=np.float32)
    if kind == "conv":
        a = a.transpose(3, 2, 0, 1)    # HWIO -> OIHW
    elif kind == "dense":
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def from_flax(variables, model) -> dict:
    """Flax ``{"params": ..., "batch_stats": ...}`` (numpy leaves) ->
    ``state_dict`` of CPU f32 tensors for ``model`` (a port ResNet, VGG,
    Inception V3 or MNIST model); ``load_state_dict`` copies them to its
    device."""
    sd = {}
    for name, coll, path, kind in _flax_layout(model):
        leaf = variables[coll]
        for key in path:
            leaf = leaf[key]
        sd[name] = _to_torch(leaf, kind)
    return sd


def to_flax(state_dict, model) -> dict:
    """The inverse of :func:`from_flax`: ``{"params", "batch_stats"}`` of
    numpy float32 leaves in flax's layout."""
    out: dict = {}
    for name, coll, path, kind in _flax_layout(model):
        a = state_dict[name].detach().float().cpu().numpy()
        if kind == "conv":
            a = a.transpose(2, 3, 1, 0)    # OIHW -> HWIO
        elif kind == "dense":
            a = a.T
        node = out.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        # A copy: a vector's array would otherwise share the tensor's
        # memory and follow every later step of the model.
        node[path[-1]] = np.array(a, order="C", copy=True)
    return out


def init_variables(model, seed: int = 0) -> dict:
    """Seeded random variables for ``model`` in flax's layout, drawn from
    an explicit ``torch.Generator``: every kernel ``N(0, 1/fan_in)``,
    biases 0, BatchNorm scales 1 except the last of each ResNet block, 0
    (the JAX model's zero init), running means 0 and variances 1."""
    from horovod_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(seed)
    last = set()
    if isinstance(model, resnet.ResNet):
        last = {f"blocks.{i}.norms.{len(b.norms) - 1}.scale"
                for i, b in enumerate(model.blocks)}
    shapes = {n: t.shape for n, t in model.state_dict().items()}
    sd = {}
    for name, _, _, kind in _flax_layout(model):
        shape = shapes[name]
        if kind in ("conv", "dense"):
            fan_in = int(np.prod(shape[1:]))
            sd[name] = torch.randn(shape, generator=gen) / fan_in ** 0.5
        elif name.endswith(".scale"):
            sd[name] = (torch.zeros if name in last else torch.ones)(shape)
        elif name.endswith(".var"):
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.zeros(shape)
    return to_flax(sd, model)


def init_state(model, seed: int = 0) -> dict:
    """Seeded random ``state_dict`` for a port CNN (CPU tensors), by way of
    :func:`init_variables`' flax layout."""
    return from_flax(init_variables(model, seed), model)
