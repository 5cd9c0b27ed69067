"""The port's long-context plan and the planner-wired transformer against
the JAX package's on the same inputs.

* ``plan_context`` over the cases of ``tests/test_context_plan.py``: the
  decisions that do not depend on the target (width, seq_local, layout,
  remat, causal, headroom, the activation estimate, the layout and remat
  parts of the reason) equal the JAX plan's, with the same precedence of
  keyword, ``HVD_TPU_CTX_*`` and planner, and the same errors.  The tiles
  are the port's kernels' own (``kernel_tiles``), not the JAX VMEM fit.
* A 2-layer transformer of width 128 with ``context_axis`` +
  ``context_plan``, weights carried by ``models/convert.py``: the JAX
  model under ``shard_map`` over 2 virtual devices, the port in 2 gloo
  processes.  Logits and gradients at the JAX transformer test's own
  tolerance (2e-4, ``tests/test_parallel.py``).
* The ``OVERLAP_PLAN`` and ``CONTEXT_PLAN`` instants on the eager
  engine's timeline (2 gloo processes, rank 0's timeline file).
"""

import io
import json
import multiprocessing
import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import schedule_plan as jsp
from horovod_tpu_torch.ops import schedule_plan as tsp
from horovod_tpu_torch.ops.flash_attention import kernel_tiles
from horovod_tpu_torch.serving.soak import free_port

TRANSFORMER_TOL = 2e-4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("HVD_TPU_CTX_LAYOUT", "HVD_TPU_CTX_BLOCK_Q",
                 "HVD_TPU_CTX_BLOCK_K", "HVD_TPU_CTX_REMAT",
                 "HVD_TPU_DEVICE_HEADROOM_MB"):
        for prefix in ("HVD_TPU_", "HOROVOD_"):
            monkeypatch.delenv(prefix + name.removeprefix("HVD_TPU_"),
                               raising=False)
    jsp._reset_for_tests()
    tsp._reset_for_tests()


def _wl(mod, s, h=16, d=128, **kw):
    return mod.ContextWorkload(seq_len=s, num_heads=h, head_dim=d, **kw)


def _reason_parts(reason: str) -> list:
    """The layout and remat parts of a plan's reason: without the JAX VMEM
    fit and the port's Hopper tiles."""
    parts = []
    for part in reason.split("; "):
        if part.startswith(("VMEM fit", "Hopper tiles")):
            continue
        if parts and parts[-1].count("(") > parts[-1].count(")"):
            parts[-1] += "; " + part   # a "; " inside parentheses
        else:
            parts.append(part)
    return parts


SHARED = ("planner", "width", "seq_local", "layout", "remat", "causal",
          "headroom_mb", "est_activation_mb")
REMAT_WL = dict(s=131072, h=16, d=128, embed_dim=2048, mlp_dim=8192,
                num_layers=16)

CASES = {
    "zigzag_default": (dict(s=32768), 8, {}),
    "width1": (dict(s=8192), 1, {}),
    "noncausal": (dict(s=8192, causal=False), 8, {}),
    "odd_shard": (dict(s=8 * 13, h=2, d=8), 8, {}),
    "pinned_zigzag_block": (dict(s=32768), 8,
                            dict(layout="zigzag", block_k=4096)),
    "pinned_plain_block": (dict(s=32768), 8,
                           dict(layout="plain", block_k=4096)),
    "remat_tight": (REMAT_WL, 8, dict(headroom_mb=64.0)),
    "remat_roomy": (REMAT_WL, 8, dict(headroom_mb=65536.0)),
    "remat_solo": (REMAT_WL, 1, dict(headroom_mb="act4")),
    "remat_wide": (REMAT_WL, 8, dict(headroom_mb="act4")),
    "remat_pinned": (dict(s=8192), 2, dict(remat=True)),
    "zigzag_elastic_8": (dict(s=256, h=2, d=8), 8, {}),
    "zigzag_elastic_4": (dict(s=256, h=2, d=8), 4, {}),
    "longctx_8k": (dict(s=8192, embed_dim=2048, mlp_dim=8192,
                        num_layers=8), 1, {}),
    "longctx_32k_2": (dict(s=32768, embed_dim=2048, mlp_dim=8192,
                           num_layers=8), 2, dict(headroom_mb=60000.0)),
    "f32": (dict(s=4096, h=4, d=64, dtype_bytes=4), 2, {}),
}


def _plans(case):
    wl_kw, width, kw = CASES[case]
    kw = dict(kw)
    wl_kw = dict(wl_kw)
    s = wl_kw.pop("s")
    plans = []
    for mod in (jsp, tsp):
        wl = _wl(mod, s, **wl_kw)
        # A pinned tile is the JAX plan's alone: the port's kernels take
        # none.
        args = {k: v for k, v in kw.items()
                if mod is jsp or k not in ("block_q", "block_k")}
        if args.get("headroom_mb") == "act4":
            args["headroom_mb"] = wl.activation_mb(4)
        headroom = args.pop("headroom_mb", None)
        plans.append(mod.plan_context(wl, width, headroom, **args))
    return plans


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_decisions_match_jax(case):
    jplan, tplan = _plans(case)
    j, t = jplan.as_dict(), tplan.as_dict()
    for key in SHARED:
        assert t[key] == j[key], (key, t, j)
    assert _reason_parts(t["reason"]) == _reason_parts(j["reason"])
    # The tiles are the port's kernels' at one call of the plan.
    wl_kw = dict(CASES[case][0])
    chunk = tplan.seq_local // 2 if tplan.layout == "zigzag" else \
        tplan.seq_local
    tiles = kernel_tiles(wl_kw.get("d", 128), wl_kw.get("dtype_bytes", 2),
                         chunk, wl_kw.get("h", 16))
    assert tplan.tiles == tiles
    assert (tplan.block_q, tplan.block_k) == tiles["flash_fwd"][:2]
    assert tplan.smem_bytes == max(v[2] for v in tiles.values()) <= 232448
    assert tsp.context_plan() == t


def test_plan_tiles_follow_the_kernels_routes():
    # bf16 at D = 128: 128-row q tiles once they fill the card's SMs;
    # f32 (CUDA cores): 64 x 64; D = 256: 32-row dq and 32-key dk/dv.
    big = kernel_tiles(128, 2, 4096, 16)
    assert big["flash_fwd"][:2] == (128, 64) == big["flash_bwd_dq"][:2]
    assert kernel_tiles(128, 2, 64, 1)["flash_fwd"][:2] == (64, 64)
    assert kernel_tiles(64, 4, 4096, 16)["flash_fwd"][:2] == (64, 64)
    wide = kernel_tiles(256, 2)
    assert wide["flash_bwd_dq"][:2] == (32, 64)
    assert wide["flash_bwd_dkv"][:2] == (64, 32)
    assert all(v[2] <= 232448 for d in (64, 96, 128, 256, 512)
               for b in (2, 4) for v in kernel_tiles(d, b).values())


def test_plan_env_below_keyword(monkeypatch):
    monkeypatch.setenv("HVD_TPU_CTX_LAYOUT", "plain")
    monkeypatch.setenv("HVD_TPU_CTX_REMAT", "1")
    for mod in (jsp, tsp):
        assert mod.plan_context(_wl(mod, 8192), 8).layout == "plain"
        assert mod.plan_context(_wl(mod, 8192), 8,
                                layout="zigzag").layout == "zigzag"
        assert mod.plan_context(_wl(mod, 8192), 8).remat is True
        assert mod.plan_context(_wl(mod, 8192), 8,
                                remat=False).remat is False
    monkeypatch.setenv("HVD_TPU_CTX_LAYOUT", "sideways")
    with pytest.warns(RuntimeWarning, match="HVD_TPU_CTX_LAYOUT"):
        assert tsp.plan_context(_wl(tsp, 8192), 8).layout == "zigzag"


def test_plan_pinned_tiles_keep_the_kernels_tiles(monkeypatch):
    # The port offers no tile pin: the JAX package's variable changes
    # nothing, and its keywords are refused.
    monkeypatch.setenv("HVD_TPU_CTX_BLOCK_K", "4096")
    plan = tsp.plan_context(_wl(tsp, 32768), 8)
    assert (plan.block_q, plan.block_k) == (128, 64)
    assert plan.tiles == kernel_tiles(128, 2, 32768 // 16, 16)
    assert "pinned" not in plan.reason
    with pytest.raises(TypeError, match="block_q"):
        tsp.plan_context(_wl(tsp, 32768), 8, block_q=256)


@pytest.mark.parametrize("args,match", [
    ((8192, 3, {}), "divisible"),
    ((8192, 0, {}), ">= 1"),
    ((8 * 13, 8, dict(layout="zigzag")), "divisible by 2\\*width"),
])
def test_plan_errors_match_jax(args, match):
    s, width, kw = args
    msgs = []
    for mod in (jsp, tsp):
        with pytest.raises(ValueError, match=match) as err:
            mod.plan_context(_wl(mod, s, h=2, d=8), width, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# -- the planner-wired transformer -------------------------------------------

DIMS = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=32,
            embed_dim=128, mlp_dim=256)
SEQ, WIDTH, SEED = 32, 2, 3


def _tokens():
    return np.random.RandomState(SEED).randint(0, DIMS["vocab_size"],
                                               (2, SEQ))


def _weights(seq):
    # Seeded dlogits-style weights for a linear loss on the logits.
    return np.random.default_rng(SEED).standard_normal(
        (2, seq, DIMS["vocab_size"])).astype(np.float32)


def _flax_params():
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return convert.flax_tree(TransformerConfig(**DIMS), SEED)


def _save(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _model_worker(rank, store, results):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.parallel import (make_ring_attention,
                                            plan_long_context,
                                            shard_sequence)

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank,
             size=WIDTH)
    try:
        out = {}
        tree = _flax_params()
        tokens = torch.from_numpy(_tokens())
        weights = torch.from_numpy(_weights(SEQ))
        for remat in (False, True):
            plan = plan_long_context(
                seq_len=SEQ, num_heads=DIMS["num_heads"],
                head_dim=DIMS["head_dim"], width=WIDTH, batch=2,
                embed_dim=DIMS["embed_dim"], mlp_dim=DIMS["mlp_dim"],
                num_layers=DIMS["num_layers"], dtype_bytes=4, remat=remat)
            cfg = TransformerConfig(**DIMS, dtype=torch.float32,
                                    context_axis=dist.group.WORLD,
                                    context_plan=plan)
            model = Transformer(cfg, device="cpu")
            model.load_state_dict(convert.params_from_flax(tree, cfg))
            sl = plan.seq_local
            mine = lambda x: shard_sequence(x, plan)[  # noqa: E731
                :, rank * sl:(rank + 1) * sl]
            logits = model(mine(tokens))
            (logits * mine(weights)).sum().backward()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            for g in grads.values():
                dist.all_reduce(g)
            out[f"plan.{remat}"] = (plan.as_dict(), logits.detach(), grads)
        # position_offset with the einsum ring, as the JAX test drives it.
        cfg = TransformerConfig(**DIMS, dtype=torch.float32,
                                attention_fn=make_ring_attention())
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(convert.params_from_flax(tree, cfg))
        sl = SEQ // WIDTH
        out["offset"] = model(tokens[:, rank * sl:(rank + 1) * sl],
                              position_offset=rank * sl).detach()
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def _spawn(worker, n, tmp_path, timeout=180):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=worker,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(n)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=timeout)
            outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
    except queue.Empty:
        pytest.fail(f"a gloo worker did not report within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return outs


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    return _spawn(_model_worker, WIDTH, tmp_path_factory.mktemp("model"))


def _jax_model(plan_layout):
    """The JAX model wired from its own plan: logits over the planned
    layout and the gradient of the same linear loss, psum'd over the
    shards."""
    from horovod_tpu.models import Transformer, TransformerConfig
    from horovod_tpu.parallel import plan_long_context, shard_sequence

    plan = plan_long_context(
        seq_len=SEQ, num_heads=DIMS["num_heads"], head_dim=DIMS["head_dim"],
        width=WIDTH, batch=2, embed_dim=DIMS["embed_dim"],
        mlp_dim=DIMS["mlp_dim"], num_layers=DIMS["num_layers"],
        dtype_bytes=4)
    assert plan.layout == plan_layout
    model = Transformer(TransformerConfig(**DIMS, dtype=jnp.float32,
                                          context_axis="sp",
                                          context_plan=plan))
    params = jax.tree.map(jnp.asarray, _flax_params())
    tokens = shard_sequence(jnp.asarray(_tokens()), plan)
    weights = shard_sequence(jnp.asarray(_weights(SEQ)), plan)
    mesh = Mesh(np.array(jax.devices()[:WIDTH]), ("sp",))

    def local(params, toks, w):
        logits, vjp = jax.vjp(lambda p: model.apply(p, toks), params)
        grads = vjp(w)[0]
        return logits, jax.tree.map(lambda g: jax.lax.psum(g, "sp"), grads)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp")),
        out_specs=(P(None, "sp"), P()), check_vma=False))(params, tokens,
                                                          weights)


def test_transformer_through_context_plan_matches_jax(hvd, port_model):
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import TransformerConfig

    logits, grads = _jax_model("zigzag")
    want_grads = convert.params_from_flax(
        jax.tree.map(np.asarray, grads),
        TransformerConfig(**DIMS, dtype=torch.float32))
    for remat in (False, True):
        plan = port_model[0][f"plan.{remat}"][0]
        assert plan["layout"] == "zigzag" and plan["remat"] is remat
        got = np.concatenate([port_model[r][f"plan.{remat}"][1].numpy()
                              for r in range(WIDTH)], axis=1)
        np.testing.assert_allclose(got, np.asarray(logits),
                                   atol=TRANSFORMER_TOL,
                                   rtol=TRANSFORMER_TOL)
        for r in range(WIDTH):
            g = port_model[r][f"plan.{remat}"][2]
            assert set(g) == set(want_grads)
            for name, want in want_grads.items():
                np.testing.assert_allclose(
                    g[name].numpy(), want.numpy(), atol=TRANSFORMER_TOL,
                    rtol=TRANSFORMER_TOL, err_msg=f"{name} remat={remat}")


def test_transformer_position_offset_ring_matches_jax_dense(hvd,
                                                             port_model):
    from horovod_tpu.models import Transformer, TransformerConfig

    dense = Transformer(TransformerConfig(**DIMS, dtype=jnp.float32))
    ref = dense.apply(jax.tree.map(jnp.asarray, _flax_params()),
                      jnp.asarray(_tokens()))
    got = np.concatenate([port_model[r]["offset"].numpy()
                          for r in range(WIDTH)], axis=1)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TRANSFORMER_TOL,
                               rtol=TRANSFORMER_TOL)


# -- timeline instants --------------------------------------------------------

def _timeline_worker(rank, store, cport, timeline, results):
    os.environ["HVD_TPU_COORDINATOR_PORT"] = str(cport)
    os.environ["HVD_TPU_EXECUTOR"] = "multihost"
    os.environ["HOROVOD_TIMELINE"] = timeline
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import schedule_plan
    from horovod_tpu_torch.parallel import plan_long_context

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        # The engine starts with the first eager collective.
        hvd.synchronize(hvd.allreduce_async(torch.ones(4), name="warm"))
        overlap = schedule_plan.plan_overlap([torch.ones(8)] * 3, width=2)
        ctx = plan_long_context(seq_len=1024, num_heads=4, head_dim=64,
                                width=2)
        results.put((rank, _save((overlap.as_dict(), ctx.as_dict()))))
    finally:
        hvd.shutdown()


def test_plan_instants_land_on_the_engine_timeline(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    timeline = str(tmp_path / "timeline.json")
    cport = free_port()
    procs = [ctx.Process(target=_timeline_worker,
                         args=(r, str(tmp_path / "store"), cport, timeline,
                               results)) for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=120)
            outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    overlap, plan = outs[0]
    text = open(timeline).read()
    events = json.loads(text if text.rstrip().endswith("]")
                        else text.rstrip().rstrip(",") + "]")
    names = [e.get("name", "") for e in events]
    want_overlap = (f"OVERLAP_PLAN planner=adaptive width=2 "
                    f"headroom=unknown depth={overlap['chain_depth']}")
    want_ctx = (f"CONTEXT_PLAN width=2 layout=zigzag "
                f"block_q={plan['block_q']} block_k={plan['block_k']} "
                f"remat=False")
    assert want_overlap in names and want_ctx in names, names
