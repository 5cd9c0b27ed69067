"""``python -m horovod_tpu_torch.train_longseq`` on the CPU against the JAX
package's long-context step (``bench.py`` ``longctx_bench``) on the same
converted weights and tokens.

The port's CLI runs with ``--device cpu`` at 2 layers, S = 256, f32
compute: alone (width 1, the plain layout) and as two gloo processes under
``python -m horovod_tpu_torch.run -np 2`` (width 2, zigzag).  The JAX side
is ``longctx_bench``'s step, written out here as bench.py writes it:
``shard_map`` over 1 or 2 of the suite's virtual devices, the model wired
from its own plan, the zigzag two-chunk loss, ``pmean`` of loss and
gradients, ``optax.adamw(3e-4)``.  The first loss is the same function of
the same weights and tokens; the later ones follow two AdamW steps, whose
first moves every parameter by about the learning rate's sign-normalised
step, so a gradient element at rounding level can turn the other way:
|Δloss| <= 1e-4 on losses near 5 (f32).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

LOSS_ATOL = 1e-4
DIMS = dict(layers=2, embed=64, heads=4, mlp=256, vocab=128)
SEQ, WARMUP, STEPS, SEED = 256, 1, 2, 0
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_args():
    return ["--device", "cpu", "--seq-lens", str(SEQ), "--layers",
            str(DIMS["layers"]), "--embed", str(DIMS["embed"]), "--heads",
            str(DIMS["heads"]), "--mlp", str(DIMS["mlp"]), "--vocab",
            str(DIMS["vocab"]), "--warmup", str(WARMUP), "--steps",
            str(STEPS), "--dtype", "float32", "--seed", str(SEED)]


def _run(cmd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                        "JAX_COORDINATOR_ADDRESS")}
    proc = subprocess.run(cmd, cwd=_REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line[line.index("{"):])
            for line in proc.stdout.splitlines()
            if "longseq_train_throughput" in line]
    assert len(rows) == 1, proc.stdout
    return rows[0]


def _jax_losses(width):
    """``longctx_bench``'s step at these widths, from the port's seeded
    flax weights and the same tokens: the losses of every step."""
    from horovod_tpu.models import Transformer, TransformerConfig
    from horovod_tpu.parallel import plan_long_context, shard_sequence
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import \
        TransformerConfig as TorchConfig

    heads, embed = DIMS["heads"], DIMS["embed"]
    base = dict(vocab_size=DIMS["vocab"], num_layers=DIMS["layers"],
                num_heads=heads, head_dim=embed // heads, embed_dim=embed,
                mlp_dim=DIMS["mlp"], max_seq_len=SEQ)
    plan = plan_long_context(seq_len=SEQ, num_heads=heads,
                             head_dim=embed // heads, width=width,
                             embed_dim=embed, mlp_dim=DIMS["mlp"],
                             num_layers=DIMS["layers"])
    model = Transformer(TransformerConfig(**base, dtype=jnp.float32,
                                          context_axis="sp",
                                          context_plan=plan))
    params = jax.tree.map(jnp.asarray,
                          convert.flax_tree(TorchConfig(**base), SEED))
    mesh = Mesh(np.array(jax.devices()[:width]), ("sp",))
    s_local = SEQ // width
    opt = optax.adamw(3e-4)
    opt_state = opt.init(params)

    def sharded(params, tokens):
        def loss_fn(p):
            ce = optax.softmax_cross_entropy_with_integer_labels
            logits = model.apply(p, tokens)
            if plan.layout == "zigzag":
                c = s_local // 2
                loss = 0.5 * (
                    ce(logits[:, :c - 1], tokens[:, 1:c]).mean()
                    + ce(logits[:, c:-1], tokens[:, c + 1:]).mean())
            else:
                loss = ce(logits[:, :-1], tokens[:, 1:]).mean()
            return jax.lax.pmean(loss, "sp")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree.map(lambda g: jax.lax.pmean(g, "sp"), grads), loss

    @jax.jit
    def train_step(params, opt_state, tokens):
        grads, loss = jax.shard_map(
            sharded, mesh=mesh, in_specs=(P(), P(None, "sp")),
            out_specs=(P(), P()), check_vma=False)(params, tokens)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tokens = shard_sequence(jnp.asarray(np.random.RandomState(SEED).randint(
        0, DIMS["vocab"], (1, SEQ))), plan)
    losses = []
    for _ in range(WARMUP + STEPS):
        params, opt_state, loss = train_step(params, opt_state, tokens)
        losses.append(float(loss))
    return plan.layout, losses


@pytest.mark.parametrize("width", [1, 2])
def test_cli_losses_match_the_jax_longctx_step(hvd, width):
    if width == 1:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.train_longseq"]
    else:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
               "--", sys.executable, "-m", "horovod_tpu_torch.train_longseq"]
    row = _run(cmd + _cli_args())
    layout, want = _jax_losses(width)
    plan = row["plan"]
    assert plan["width"] == row["processes"] == width
    assert plan["layout"] == layout == ("zigzag" if width == 2 else "plain")
    assert plan["remat"] is False and plan["seq_local"] == SEQ // width
    assert row["seq_len"] == SEQ and row["tok_per_s"] > 0
    np.testing.assert_allclose(row["losses"], want, atol=LOSS_ATOL, rtol=0)
    assert row["losses"][-1] < row["losses"][0]


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    # Without --device the trainer asks for cuda, which this host lacks.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from horovod_tpu_torch import train_longseq

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID",
                 "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        train_longseq.main(["--seq-lens", "64", "--layers", "1"])


@pytest.mark.parametrize("seq,remat", [(8192, False), (32768, False),
                                       (131072, True)])
def test_plan_weighs_activations_against_room_beside_the_trainer(
        monkeypatch, seq, remat):
    # The plan's headroom is the card's free memory less what the trainer
    # holds beside the activations: at full width, 0.67 B f32 parameters
    # four times over (10.7 GB) and the f32 logits with their gradient.
    # On an 80 GB card (80384 MB free, as the H100 probes) S = 131072
    # then takes remat, and the JAX plan decides the same on that room.
    from horovod_tpu.ops import schedule_plan as jsp
    from horovod_tpu_torch import train_longseq as tl
    from horovod_tpu_torch.ops import schedule_plan as tsp

    monkeypatch.setenv("HVD_TPU_DEVICE_HEADROOM_MB", "80384")
    monkeypatch.setattr(tl.basics, "size", lambda: 1)
    monkeypatch.setattr(tl, "context_group", lambda: None)
    plan = tl.plan_for(seq)
    cfg = tl.longseq_config(None, seq)
    params = 667977728
    want = 80384 - (16 * params + 2 * seq * 32000 * 4) / 2 ** 20
    assert tl.trainer_resident_mb(cfg, seq) == pytest.approx(
        80384 - want, rel=1e-12)
    assert plan.headroom_mb == pytest.approx(want, rel=1e-12)
    assert plan.remat is remat and plan.layout == "plain"
    jplan = jsp.plan_context(jsp.ContextWorkload(
        seq_len=seq, num_heads=16, head_dim=128, embed_dim=2048,
        mlp_dim=8192, num_layers=8), 1, plan.headroom_mb)
    assert jplan.remat is remat
    tsp._reset_for_tests()
    jsp._reset_for_tests()
