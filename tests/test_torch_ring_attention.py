"""The port's ring and Ulysses attention against the JAX package's on the
same numpy inputs (zigzag: ``tests/test_torch_zigzag.py``).

The JAX side runs as its own tests run it: ``shard_map`` over 2 or 4 of
the suite's 8 virtual CPU devices, the Pallas flash kernels in interpret
mode.  The port runs in 2 or 4 gloo processes on the CPU, where the flash
wrappers take their plain versions and the ring's exchange is
``batch_isend_irecv`` on host tensors.  Each process returns its output
shard and its gradient shards for one seeded output cotangent.

Tolerances are the JAX tests' own (``tests/test_parallel.py``,
``tests/test_zigzag.py``): 2e-5 on outputs, 5e-4 on gradients; the
zigzag permutation and positions are compared bit for bit.
"""

import io
import multiprocessing
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import parallel as jpar
from horovod_tpu_torch import parallel as tpar

OUT_TOL, GRAD_TOL = 2e-5, 5e-4
S, H, D, B = 32, 4, 8, 2
BLOCK = 4     # the JAX kernels' tiles (interpret mode); the port ignores them


def _inputs(h=H):
    rng = np.random.default_rng(7)
    q, k, v, dout = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                     for _ in range(4))
    return q, k, v, dout


def _save(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _fwd_bwd(fn, shards, dout):
    """Output and (dq, dk, dv) of ``fn`` on torch copies of ``shards``."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
               for a in shards)
    out = fn(q, k, v)
    (out * torch.from_numpy(np.ascontiguousarray(dout))).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in (q, k, v)]


def _worker(rank, n, kinds, store, results):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=n)
    try:
        q, k, v, dout = _inputs()
        sl = S // n
        mine = lambda a: a[:, rank * sl:(rank + 1) * sl]  # noqa: E731
        zig = par.zigzag_permutation(S, n)
        zmine = lambda a: mine(a[:, zig])  # noqa: E731
        out = {"positions": par.zigzag_positions(sl).numpy()}
        par.reset_exchange_stats()
        for causal in (True, False):
            if "zigzag" in kinds:
                out[f"zigzag.{causal}"] = _fwd_bwd(
                    lambda q, k, v: par.zigzag_ring_flash_attention(
                        q, k, v, None, causal),
                    [zmine(a) for a in (q, k, v)], zmine(dout))
            if "ring" not in kinds:
                continue
            out[f"ring_flash.{causal}"] = _fwd_bwd(
                lambda q, k, v: par.ring_flash_attention(q, k, v, None,
                                                         causal),
                [mine(a) for a in (q, k, v)], mine(dout))
            out[f"ring.{causal}"] = _fwd_bwd(
                lambda q, k, v: par.ring_attention(q, k, v, None, causal),
                [mine(a) for a in (q, k, v)], mine(dout))
            out[f"ulysses.{causal}"] = _fwd_bwd(
                lambda q, k, v: par.ulysses_attention(q, k, v, None, causal),
                [mine(a) for a in (q, k, v)], mine(dout))
            out[f"ulysses_flash.{causal}"] = _fwd_bwd(
                lambda q, k, v: par.make_ulysses_flash_attention(None)(
                    q, k, v, causal=causal),
                [mine(a) for a in (q, k, v)], mine(dout))
            stats_out, steps = par.ring_flash_attention_stats(
                *(torch.from_numpy(np.ascontiguousarray(mine(a)))
                  for a in (q, k, v)), None, causal)
            out[f"steps.{causal}"] = (steps, stats_out.numpy())
        out["exchange"] = par.exchange_stats()
        try:
            bad = torch.zeros(1, sl, 3 if n == 2 else 6, D)
            par.ulysses_attention(bad, bad, bad)
            out["ulysses_error"] = None
        except ValueError as e:
            out["ulysses_error"] = str(e)
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def run_workers(n, kinds, tmp_path, timeout=180):
    """Each of ``n`` gloo processes' results for ``kinds`` (``ring``: the
    plain ring, einsum ring, Ulysses and the error; ``zigzag``)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, n, kinds, str(tmp_path / "store"),
                               results))
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


@pytest.fixture(scope="module", params=[2, 4])
def port(request, tmp_path_factory):
    n = request.param
    return n, run_workers(n, ("ring",),
                          tmp_path_factory.mktemp(f"ring{n}"))


def jax_fwd_bwd(fn, n, args, dout):
    """``shard_map`` of ``fn`` over ``n`` devices on ``args`` (global
    arrays, sharded on the sequence): output and (dq, dk, dv)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=P(None, "sp"),
                            out_specs=P(None, "sp"), check_vma=False)

    @jax.jit
    def fwd_bwd(q, k, v, dout):
        out, vjp = jax.vjp(sharded, q, k, v)
        return (out,) + vjp(dout)

    return [np.asarray(x) for x in fwd_bwd(*(jnp.asarray(a)
                                             for a in (*args, dout)))]


def gathered(port_out, key, n, i):
    """Element ``i`` of every rank's ``key`` result, joined on the
    sequence."""
    return np.concatenate([port_out[r][key][i] for r in range(n)], axis=1)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["ring_flash", "ring"])
def test_ring_matches_jax_forward_and_backward(hvd, port, kind, causal):
    n, outs = port
    q, k, v, dout = _inputs()
    args = (q, k, v)
    if kind == "ring_flash":
        fn = lambda q, k, v: jpar.ring_flash_attention(  # noqa: E731
            q, k, v, "sp", causal, block_q=BLOCK, block_k=BLOCK)
    else:
        fn = lambda q, k, v: jpar.ring_attention(  # noqa: E731
            q, k, v, "sp", causal=causal)
    want = jax_fwd_bwd(fn, n, args, dout)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        _close(gathered(outs, f"{kind}.{causal}", n, i), want[i],
               OUT_TOL if i == 0 else GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["ulysses", "ulysses_flash"])
def test_ulysses_matches_jax_forward_and_backward(hvd, port, kind, causal):
    n, outs = port
    q, k, v, dout = _inputs()
    attn = (jpar.make_ulysses_flash_attention("sp", block_q=8, block_k=8)
            if kind == "ulysses_flash" else jpar.make_ulysses_attention("sp"))
    want = jax_fwd_bwd(lambda q, k, v: attn(q, k, v, causal=causal), n,
                        (q, k, v), dout)
    for i in range(4):
        _close(gathered(outs, f"{kind}.{causal}", n, i), want[i],
               OUT_TOL if i == 0 else GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(hvd, port):
    n, outs = port
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    x = jnp.zeros((1, S, 3 if n == 2 else 6, D))
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jax.shard_map(lambda q, k, v: jpar.ulysses_attention(q, k, v, "sp"),
                      mesh=mesh, in_specs=P(None, "sp"),
                      out_specs=P(None, "sp"))(x, x, x)
    for r in range(n):
        assert outs[r]["ulysses_error"] == str(jax_err.value)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_layout_steps_run_match_jax(hvd, port, causal):
    n, outs = port
    q, k, v, _ = _inputs()
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))

    def f(q, k, v):
        out, steps = jpar.ring_flash_attention_stats(
            q, k, v, "sp", causal, block_q=BLOCK, block_k=BLOCK)
        return out, steps[None]

    want_out, want_steps = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
        out_specs=(P(None, "sp"), P("sp")), check_vma=False))(q, k, v)
    got = [outs[r][f"steps.{causal}"][0] for r in range(n)]
    assert got == [int(s) for s in want_steps]
    assert got == ([r + 1 for r in range(n)] if causal else [n] * n)
    _close(np.concatenate([outs[r][f"steps.{causal}"][1] for r in range(n)],
                          axis=1), np.asarray(want_out), OUT_TOL)


def test_zigzag_permutation_and_positions_bitwise(hvd, port):
    n, outs = port
    for s in (S, 8 * n, 64):
        np.testing.assert_array_equal(tpar.zigzag_permutation(s, n),
                                      jpar.zigzag_permutation(s, n))
        np.testing.assert_array_equal(
            tpar.zigzag_inverse_permutation(s, n),
            jpar.zigzag_inverse_permutation(s, n))
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    pos = jax.shard_map(lambda: jpar.zigzag_positions(S // n, "sp"),
                        mesh=mesh, in_specs=(), out_specs=P("sp"),
                        check_vma=False)()
    got = np.concatenate([outs[r]["positions"] for r in range(n)])
    np.testing.assert_array_equal(got, np.asarray(pos))


def test_exchange_counts_each_rotation(port):
    # Per causal setting and rank: ring_flash n-1 K/V exchanges forward,
    # n-1 K/V and n dk/dv backward; ring_attention's einsum rotations are
    # one exchange a tensor, forward and back; the stats pass n-1.
    n, outs = port
    per = ((n - 1) + (2 * n - 1)) + 4 * (n - 1) + (n - 1)
    for r in range(n):
        ex = outs[r]["exchange"]
        assert ex["exchanges"] == 2 * per
        assert ex["bytes"] > 0 and ex["host_ms"] >= 0
