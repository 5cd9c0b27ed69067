"""The port's recipes (``horovod_tpu_torch.examples``: ``mnist``,
``mnist_advanced``, ``imagenet_resnet50``, ``word2vec``, ``torch_mnist``,
``torch_synthetic_benchmark``) through the tests of
``tests/test_examples.py`` that run their JAX twins: one process, two
processes under the port's launcher (rank-tagged final metrics, equal on
every rank), resume, and the fault-injected restart; and one step of
``mnist`` and of ``word2vec`` against the JAX package's computation on the
same numpy inputs.

Where the JAX test runs one process of eight virtual chips, the port runs
one card a process: the batch flags below keep the JAX test's global
batch (``--batch-size 4`` on eight chips is 32 images a step), and the
``mnist`` runs take a quarter of its 4096 synthetic rows
(``--num-samples 1024``) to stay inside a minute on a loaded host.  The
slow marks are the JAX twins'.  The subprocesses run with two intra-op
threads a process: the suite runs six files at once on this host."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _timing import scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "horovod_tpu_torch.examples."


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
           **extra}
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


def _run(module, *args, timeout=180, env=None):
    out = subprocess.run(
        [sys.executable, "-m", PKG + module, "--device", "cpu", *args],
        capture_output=True, text=True, timeout=scaled(timeout),
        env=_env(**(env or {})), cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout


def _run_np2(module, *args, timeout=240):
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
         sys.executable, "-m", PKG + module, "--device", "cpu", *args],
        capture_output=True, text=True, timeout=scaled(timeout),
        env=_env(), cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-2000:])
    return out.stdout


def _final_metrics(out: str, np_: int = 2) -> dict:
    vals = {}
    for line in out.splitlines():
        m = re.search(r"\[rank (\d+)/(\d+)\] final (.+)$", line)
        if m:
            assert int(m.group(2)) == np_
            vals[int(m.group(1))] = m.group(3).strip()
    assert set(vals) == set(range(np_)), out[-2500:]
    return vals


# -- one process --------------------------------------------------------------

def test_mnist(tmp_path):
    out = _run("mnist", "--epochs", "1", "--batch-size", "32",
               "--num-samples", "1024", "--ckpt-dir", str(tmp_path / "ck"))
    assert "epoch 0" in out and "loss=" in out
    assert "[rank 0/1] final loss=" in out


def test_mnist_advanced():
    out = _run("mnist_advanced")
    assert "finished gradual learning rate warmup" in out


def test_torch_mnist():
    out = _run("torch_mnist", "--epochs", "1")
    assert "epoch 0" in out


def test_word2vec():
    out = _run("word2vec", "--steps", "5", "--vocab", "500", "--dim", "32")
    assert "step 0" in out


def test_torch_mnist_resume(tmp_path):
    ck = str(tmp_path / "tck")
    _run("torch_mnist", "--epochs", "1", "--ckpt-dir", ck)
    out = _run("torch_mnist", "--epochs", "2", "--ckpt-dir", ck)
    assert "resumed from epoch 0" in out
    assert "epoch 1:" in out and "epoch 0:" not in out


@pytest.mark.slow
def test_imagenet_resnet50(tmp_path):
    out = _run("imagenet_resnet50", "--epochs", "1", "--steps-per-epoch",
               "1", "--batch-size", "1", "--ckpt-dir", str(tmp_path / "r50"),
               timeout=560)
    assert "epoch 0" in out


def test_examples_refuse_to_fall_back_to_the_cpu():
    # No --device: the default is the card, and this host has none.
    out = subprocess.run(
        [sys.executable, "-m", PKG + "word2vec", "--steps", "1"],
        capture_output=True, text=True, timeout=scaled(120), env=_env(),
        cwd=REPO)
    assert out.returncode != 0
    assert "none is available" in out.stderr, out.stderr[-2000:]
    assert "step 0" not in out.stdout


# -- two processes under the launcher ----------------------------------------

def test_mnist_np2(tmp_path):
    out = _run_np2("mnist", "--epochs", "1", "--batch-size", "32",
                   "--num-samples", "1024",
                   "--ckpt-dir", str(tmp_path / "ck2"))
    assert "[0]: " in out and "[1]: " in out
    vals = _final_metrics(out)
    assert vals[0] == vals[1], vals


def test_torch_mnist_np2(tmp_path):
    out = _run_np2("torch_mnist", "--epochs", "1",
                   "--ckpt-dir", str(tmp_path / "tck2"))
    assert "[0]: " in out and "[1]: " in out
    vals = _final_metrics(out)
    assert vals[0] == vals[1], vals


def test_torch_synthetic_benchmark_np2():
    out = _run_np2("torch_synthetic_benchmark", "--model", "mlp",
                   "--hidden", "64", "--num-warmup-batches", "2",
                   "--num-batches-per-iter", "2", "--num-iters", "2")
    assert re.search(r"Img/sec per worker: [\d.]+", out), out[-2000:]
    assert re.search(r"Total img/sec on 2 worker\(s\)", out), out[-2000:]


def test_mnist_advanced_np2():
    out = _run_np2("mnist_advanced")
    assert "[0]: " in out and "[1]: " in out
    assert "finished gradual learning rate warmup" in out
    vals = _final_metrics(out)
    assert vals[0] == vals[1], vals


def test_word2vec_np2():
    out = _run_np2("word2vec", "--steps", "5", "--vocab", "500", "--dim",
                   "32")
    assert "[0]: step 0" in out
    vals = _final_metrics(out)
    assert vals[0] == vals[1], vals


def test_mnist_fault_injected_restart(tmp_path):
    """The injector kills rank 0 in epoch 1, the launcher relaunches, the
    run resumes from the epoch-0 checkpoint and completes.  1024 samples
    at 128 a step are 8 steps an epoch, so step 10 is inside epoch 1, as
    in the JAX test (4096 samples at 64 a chip on eight chips)."""
    ck = str(tmp_path / "elastic_ck")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         "--max-restarts", "1", "--ckpt-dir", ck, "--",
         sys.executable, "-m", PKG + "mnist", "--device", "cpu",
         "--epochs", "2", "--batch-size", "128", "--num-samples", "1024",
         "--ckpt-dir", ck],
        capture_output=True, text=True, timeout=scaled(420),
        env=_env(HVD_TPU_RESTART_BACKOFF="0.1", HVD_TPU_FAULT_KILL_RANK="0",
                 HVD_TPU_FAULT_KILL_STEP="10"), cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-2000:])
    assert "killing rank 0 at step 10" in out.stdout + out.stderr
    assert "restarting (attempt 1" in out.stderr, out.stderr[-1500:]
    assert "resumed from epoch 0" in out.stdout, out.stdout[-2500:]
    assert "epoch 1:" in out.stdout


@pytest.mark.slow
def test_imagenet_resnet50_np2_resume(tmp_path):
    ck = str(tmp_path / "r50np2")
    out1 = _run_np2("imagenet_resnet50", "--epochs", "1",
                    "--steps-per-epoch", "1", "--batch-size", "2",
                    "--ckpt-dir", ck, timeout=560)
    assert "epoch 0" in out1
    vals = _final_metrics(out1)
    assert vals[0] == vals[1], vals
    out2 = _run_np2("imagenet_resnet50", "--epochs", "2",
                    "--steps-per-epoch", "1", "--batch-size", "2",
                    "--ckpt-dir", ck, timeout=560)
    assert "resumed from epoch 0" in out2
    assert "epoch 1:" in out2 and "epoch 0:" not in out2
    vals = _final_metrics(out2)
    assert vals[0] == vals[1], vals


# -- one step against the JAX package ----------------------------------------

@pytest.fixture()
def world1(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_mnist_steps_match_flax_and_optax(world1):
    """Two ``mnist.train_step`` s (the second carries the first's momentum)
    from weights carried by ``models/convert.py``, against flax's
    ``MnistCNN`` under ``optax.sgd(momentum=0.9)``: f32, rtol 1e-5."""
    from horovod_tpu.models import MnistCNN
    from horovod_tpu_torch.examples import mnist
    from horovod_tpu_torch.examples._common import synthetic_mnist
    from horovod_tpu_torch.models import convert

    lr = 0.001
    model = mnist.make_model("cpu", seed=3)
    opt = mnist.make_optimizer(model, lr)
    variables = convert.to_flax(model.state_dict(), model)
    x, y = synthetic_mnist(16, seed=1)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    jopt = optax.sgd(lr, momentum=0.9)
    state = jopt.init(params)

    def loss_fn(p):
        logits = MnistCNN().apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    for _ in range(2):
        jl, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tl = mnist.train_step(model, opt, torch.from_numpy(x),
                              torch.from_numpy(y))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = dict(_leaves(convert.to_flax(model.state_dict(), model)))
    for path, want in _leaves(jax.tree_util.tree_map(np.asarray, params)):
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-7,
                                   err_msg="/".join(path))


def test_word2vec_step_matches_jnp_and_optax(world1):
    """One ``word2vec.train_step`` against the JAX example's computation
    (the gathered rows' gradient scatter-added, the output matrix's
    dense): f32, atol 1e-6."""
    from horovod_tpu_torch.examples import word2vec

    vocab, dim, batch, lr = 300, 16, 32, 0.05
    emb, out_w = (t.numpy() for t in word2vec.init_tables(vocab, dim, "cpu"))
    rng = np.random.RandomState(7)
    centers = rng.randint(0, vocab, batch)
    contexts = rng.randint(0, vocab, batch)
    # Repeated centres: the scatter-add has to merge them.
    centers[:4] = centers[4]

    def loss_fn(vec, w):
        return optax.softmax_cross_entropy_with_integer_labels(
            vec @ w.T, jnp.asarray(contexts)).mean()

    vec = jnp.asarray(emb)[jnp.asarray(centers)]
    jl, (g_vec, g_out) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        vec, jnp.asarray(out_w))
    g_emb = jnp.zeros_like(jnp.asarray(emb)).at[jnp.asarray(centers)].add(
        g_vec)
    want_emb = np.asarray(jnp.asarray(emb) - lr * g_emb)
    want_out = np.asarray(jnp.asarray(out_w) - lr * g_out)

    t_emb, t_out, tl = word2vec.train_step(
        torch.from_numpy(emb), torch.from_numpy(out_w),
        torch.from_numpy(centers), torch.from_numpy(contexts), lr)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6)
    np.testing.assert_allclose(t_emb.numpy(), want_emb, atol=1e-6)
    np.testing.assert_allclose(t_out.numpy(), want_out, atol=1e-6)
    assert not np.array_equal(t_emb.numpy(), emb)   # the rows moved
