"""Rules of the PyTorch/CUDA port: no JAX and nothing of ``horovod_tpu`` in
``horovod_tpu_torch``; entry points on CUDA unless asked for the CPU; a CUDA
tensor launches its kernel or raises, and a build failure raises."""

import ast
import contextlib
import ctypes
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch
from horovod_tpu_torch import basics
from horovod_tpu_torch.models import transformer as ttm
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import rmsnorm as trn
from horovod_tpu_torch.utils.device import resolve_device

PKG_DIR = os.path.dirname(horovod_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="horovod_tpu_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "horovod_tpu_torch.serving.engine" in mods
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: __import__(m)\n"
        "print(json.dumps([sorted(before), sorted(set(sys.modules) - before)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    before, new = json.loads(out.strip().splitlines()[-1])
    assert not [m for m in before if _forbidden(m)], \
        "the interpreter imported JAX before the port"
    assert not [m for m in new if _forbidden(m)]
    assert "horovod_tpu_torch.serving.engine" in new


def test_the_walk_covers_every_example_module():
    # The two tests around this one reach the example entry points through
    # the package walk; every module file under examples/ is in it.
    ex_dir = os.path.join(PKG_DIR, "examples")
    files = sorted(f[:-3] for f in os.listdir(ex_dir)
                   if f.endswith(".py") and f != "__init__.py")
    assert len(files) >= 13, files
    mods = _modules()
    assert "horovod_tpu_torch.examples" in mods
    assert [f for f in files
            if f"horovod_tpu_torch.examples.{f}" not in mods] == []


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
    if f.endswith(".py")) + [os.path.join(REPO, "chip_smoke.py")])
def test_no_import_statement_names_jax(path):
    # Also catches imports inside functions, which sys.modules misses.
    tree = ast.parse(open(path).read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    assert not [n for n in names if _forbidden(n)], path


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttm.TransformerConfig(vocab_size=8, num_layers=1, num_heads=1,
                                head_dim=4, embed_dim=4, mlp_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttm.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttm.init_kv_cache(cfg, 1, 4)
    assert ttm.Transformer(cfg, device="cpu").embed.weight.device.type == "cpu"
    assert ttm.init_kv_cache(cfg, 1, 4, device="cpu")[0].device.type == "cpu"


class _FakeKernel:
    """Stands in for a built kernel on this CPU host: counts launches the
    way ``_build.Kernel.__call__`` does, keeps the arguments, and launches
    nothing; ``effect`` may act on the arguments as the kernel would."""

    def __init__(self, effect=None):
        self.launches, self.calls, self.effect = 0, [], effect

    def __call__(self, *args):
        self.launches += 1
        self.calls.append(args)
        if self.effect is not None:
            self.effect(*args)


def test_cuda_flash_wrapper_trains_through_the_backward_kernels(monkeypatch):
    # Treat these CPU tensors as CUDA ones, with the kernels stubbed: a
    # requires_grad input goes through the autograd.Function, whose
    # backward launches both backward kernels, and never falls back.
    monkeypatch.setattr(tfa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    fakes = {name: _FakeKernel() for name in ("KERNEL", "DQ_KERNEL",
                                              "DKV_KERNEL")}
    for name, fake in fakes.items():
        monkeypatch.setattr(tfa, name, fake)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64)
    out = tfa.flash_attention(q, k, v)
    assert "_Flash" in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert [f.launches for f in fakes.values()] == [1, 1, 1]
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.flash_attention_with_lse(q, k, v)
    # Head dims past 256 launch the kernels too, padded to a multiple of
    # 64 (test_cuda_flash_wrapper_pads_the_head_dim), and so does a batch *
    # heads past 65535 (the kernels put it on the grid's x axis).
    for shape in ((1, 8, 2, 264), (65536, 1, 1, 8)):
        tfa.flash_attention(*(torch.randn(*shape, requires_grad=True)
                              for _ in range(3))).sum().backward()
        fwd = fakes["KERNEL"].calls[-1]
        assert (fwd[6], fwd[7], fwd[10]) == (shape[0], shape[2],
                                             tfa.kernel_head_dim(shape[3]))
    assert [f.launches for f in fakes.values()] == [3, 3, 3]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(*(torch.randn(1, 8, 2, 64).half()
                              for _ in range(3)))
    with pytest.raises(ValueError, match="delta must be"):
        tfa.flash_attention_backward(q.detach(), k, v, k,
                                     torch.zeros(1, 8, 2),
                                     torch.zeros(1, 8, 3))
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda t: t is not k))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q.detach(), k, v)
    assert [f.launches for f in fakes.values()] == [3, 3, 3]


def test_cuda_flash_wrapper_pads_the_head_dim(monkeypatch):
    # A head dim other than 64, 128 and 256 goes to the kernels zero-padded
    # to the next of them (past 256, to the next multiple of 64: the wide
    # route), from contiguous copies, with the scale of its own head dim;
    # the results come back at that head dim.
    monkeypatch.setattr(tfa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tfa._build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    fakes = {name: _FakeKernel() for name in ("KERNEL", "DQ_KERNEL",
                                              "DKV_KERNEL")}
    for name, fake in fakes.items():
        monkeypatch.setattr(tfa, name, fake)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for d, d_kernel in ((8, 64), (32, 64), (64, 64), (96, 128), (128, 128),
                        (160, 256), (256, 256), (257, 320), (320, 320),
                        (384, 384), (500, 512), (1000, 1024)):
        assert tfa.kernel_head_dim(d) == d_kernel
        # q a transposed view, as ring attention's chunks are: not
        # contiguous.
        q = torch.randn(1, 2, 8, d).transpose(1, 2).requires_grad_()
        k, v = torch.randn(1, 8, 2, d), torch.randn(1, 8, 2, d)
        out = tfa.flash_attention(q, k, v)
        out.sum().backward()
        assert out.shape == q.shape and out.is_contiguous()
        assert q.grad.shape == q.shape
        fwd, dq, dkv = (fakes[n].calls[-1] for n in ("KERNEL", "DQ_KERNEL",
                                                     "DKV_KERNEL"))
        assert fwd[10] == dq[12] == dkv[13] == d_kernel       # D
        assert fwd[-2] == dq[-3] == dkv[-2] == pytest.approx(
            d ** -0.5 * tfa.LOG2E)                           # qscale
        assert dq[-2] == pytest.approx(d ** -0.5)            # scale


def _write_dscale(x, dy, scale, dx, part, dscale, counters, n_counters,
                  dtype, n, e, eps, blocks, stream):
    """What the backward kernel leaves behind: dscale (here 0, 1, ..., e-1)
    written, from zeroed ticket counters that it leaves zeroed."""
    assert n_counters == trn.BWD_COUNTERS >= 1 + -(-blocks // 16)
    assert list((ctypes.c_int32 * n_counters).from_address(counters)) == \
        [0] * n_counters
    want = torch.arange(e, dtype=torch.float32)
    ctypes.memmove(dscale, want.data_ptr(), 4 * e)


def test_cuda_rmsnorm_wrapper_trains_through_the_backward_kernel(monkeypatch):
    monkeypatch.setattr(trn, "_on_cuda", lambda t: True)
    monkeypatch.setattr(trn._build, "stream_of", lambda t: None)
    monkeypatch.setattr(trn, "_WORKSPACES", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    fwd, bwd = _FakeKernel(), _FakeKernel(_write_dscale)
    monkeypatch.setattr(trn, "KERNEL", fwd)
    monkeypatch.setattr(trn, "BWD_KERNEL", bwd)
    x = torch.randn(4, 32, requires_grad=True)
    scale = torch.ones(32, requires_grad=True)
    y = trn.rms_norm(x, scale)
    y.sum().backward()
    assert x.grad.shape == x.shape
    # One launch per backward, and dscale is what the kernel wrote: the
    # wrapper sums no partials of its own.
    assert (fwd.launches, bwd.launches) == (1, 1)
    assert torch.equal(scale.grad, torch.arange(32, dtype=torch.float32))
    trn.rms_norm_backward(x.detach(), scale.detach(), torch.ones(4, 32))
    assert bwd.launches == 2
    assert bwd.calls[0][6] == bwd.calls[1][6]   # one workspace per stream
    assert len(trn._WORKSPACES) == 1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trn.rms_norm(x.detach().half(), scale.detach())
    assert (fwd.launches, bwd.launches) == (1, 2)
    # Any width launches: rows past WIDE_BWD_WIDTH take the wide form, a
    # block a row, so the same N spreads over more blocks.
    for e, blocks in ((trn.WIDE_BWD_WIDTH, 3), (trn.WIDE_BWD_WIDTH + 1, 20),
                      (65536, 20)):
        trn.rms_norm_backward(torch.randn(20, e), torch.ones(e),
                              torch.randn(20, e))
        assert bwd.calls[-1][-2] == blocks
    assert bwd.launches == 5


def test_process_identity_before_init_raises(monkeypatch):
    monkeypatch.setattr(basics, "_topology", None)
    for fn in (horovod_tpu_torch.rank, horovod_tpu_torch.size,
               horovod_tpu_torch.num_chips, basics.device):
        with pytest.raises(horovod_tpu_torch.NotInitializedError):
            fn()


def test_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(basics, "_topology", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        horovod_tpu_torch.init()
    assert not horovod_tpu_torch.is_initialized()


def test_build_failure_propagates(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    kernel = _build.Kernel("flash_fwd", "hvd_flash_fwd", [])
    with pytest.raises(RuntimeError, match="nvcc failed.*exit 3"):
        kernel.load()
    assert not list((tmp_path / "build").iterdir())   # no partial library
    with pytest.raises(RuntimeError, match="refused"):   # a launch too
        kernel()
    assert kernel.launches == 0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("rc,match", [(2, "cudaError 2"),
                                      (-1, "unsupported")])
def test_failed_launch_raises_and_is_not_counted(rc, match):
    kernel = _build.Kernel("flash_fwd", "hvd_flash_fwd", [])
    kernel._fn = lambda *args: rc
    with pytest.raises(RuntimeError, match=match):
        kernel()
    assert kernel.launches == 0
    kernel._fn = lambda *args: 0
    kernel()
    assert kernel.launches == 1


def test_library_name_follows_included_headers_and_flags(monkeypatch,
                                                          tmp_path):
    # An edited shared header must rebuild every kernel that includes it.
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    kernel = _build.Kernel("flash_fwd", "hvd_flash_fwd", [])
    assert [os.path.basename(p) for p in kernel.sources()] == [
        "flash_fwd.cu", "hopper.cuh"]
    norm = _build.Kernel("rmsnorm_fwd", "hvd_rmsnorm_fwd", [])
    assert [os.path.basename(p) for p in norm.sources()] == [
        "rmsnorm_fwd.cu", "rmsnorm.cuh"]
    before, norm_before = kernel.library_path(), norm.library_path()
    (csrc / "unrelated.cuh").write_text("// included by no kernel\n")
    assert kernel.library_path() == before
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    edited = kernel.library_path()
    assert edited != before
    assert os.path.basename(edited).startswith("flash_fwd-")
    assert norm.library_path() == norm_before   # not its header
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-lineinfo",))
    assert kernel.library_path() != edited
    assert norm.library_path() != norm_before


def test_library_name_follows_source_and_flags():
    k = _build.KERNELS["flash_fwd"]
    path = k.library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert os.path.basename(path).startswith("flash_fwd-")
    assert sorted(_build.KERNELS) == ["decode_attention", "flash_bwd_dkv",
                                      "flash_bwd_dq", "flash_fwd",
                                      "rmsnorm_bwd", "rmsnorm_fwd"]
    for k in _build.KERNELS.values():
        assert os.path.exists(k.source)


# -- the native core's own copy (fleet serving) -------------------------------

FLEET_MODULES = (
    "horovod_tpu_torch.core._build", "horovod_tpu_torch.core.engine",
    "horovod_tpu_torch.core.executors", "horovod_tpu_torch.utils.backoff",
    "horovod_tpu_torch.analysis.schedule", "horovod_tpu_torch.faults",
    "horovod_tpu_torch.dataplane", "horovod_tpu_torch.replication",
    "horovod_tpu_torch.elastic", "horovod_tpu_torch.serving.worker",
    "horovod_tpu_torch.serving.soak", "horovod_tpu_torch.serving.__main__")


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_fleet_module_is_checked(mod):
    # Walked by the two import checks above, which it passes.
    assert mod in _modules()
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    test_no_import_statement_names_jax(path)


def test_fleet_modules_alone_import_no_jax_and_nothing_of_horovod_tpu():
    code = ("import json, sys\n"
            f"for m in {FLEET_MODULES!r}: __import__(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert not [m for m in json.loads(out.strip().splitlines()[-1])
                if _forbidden(m)]


def test_core_library_is_built_from_the_port_sources_into_build():
    from horovod_tpu_torch.core import _build as core_build
    from horovod_tpu_torch.core import engine as core_engine

    assert core_build.SRC == os.path.join(PKG_DIR, "core", "src")
    assert core_build.BUILD_DIR == os.path.join(REPO, "build",
                                                "horovod_tpu_torch", "core")
    path = core_build.build()
    assert os.path.dirname(path) == core_build.BUILD_DIR
    assert os.path.basename(path).startswith("libhvdcore-")
    assert core_engine.lib()._name == path
    # Every source the JAX package's Makefile links, and no tool of its.
    assert sorted(f for f in os.listdir(core_build.SRC) if f.endswith(".cc")) \
        == sorted(s + ".cc" for s in core_build.SOURCES)
    # Nothing is written inside the package.
    assert not [f for f in os.listdir(core_build.SRC)
                if f.endswith((".o", ".so"))]
    assert not [f for f in os.listdir(os.path.join(PKG_DIR, "core"))
                if f.endswith(".so")]


def test_core_library_name_follows_sources_and_flags(monkeypatch, tmp_path):
    from horovod_tpu_torch.core import _build as core_build

    src = tmp_path / "src"
    shutil.copytree(core_build.SRC, src)
    monkeypatch.setattr(core_build, "SRC", str(src))
    flags = core_build.CXX_FLAGS
    before = core_build.library_path(flags)
    with open(src / "half.h", "a") as f:
        f.write("// edited\n")
    assert core_build.library_path(flags) != before
    assert core_build.library_path(flags + ("-g",)) != \
        core_build.library_path(flags)


def test_core_build_failure_raises_and_never_falls_back(monkeypatch,
                                                       tmp_path):
    from horovod_tpu_torch.core import _build as core_build
    from horovod_tpu_torch.core import engine as core_engine

    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(core_build, "_cxx", lambda: str(fake))
    monkeypatch.setattr(core_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(core_build, "_lib", None)
    monkeypatch.setattr(core_engine, "_lib", None)
    # Another library named in the environment is never loaded instead.
    monkeypatch.setenv("HVD_CORE_LIB", os.path.join(
        REPO, "horovod_tpu", "core", "libhvdcore.so"))
    with pytest.raises(RuntimeError, match="refused"):
        core_engine.lib()
    with pytest.raises(RuntimeError, match="refused"):
        core_build.load()
    assert core_build._lib is None and core_engine._lib is None
    # No partial library: only the lock file is left.
    assert [p.name for p in (tmp_path / "build").iterdir()] == [".lock"]


def test_core_build_without_a_compiler_raises(monkeypatch):
    from horovod_tpu_torch.core import _build as core_build

    monkeypatch.setattr(core_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+17 compiler"):
        core_build._cxx()


# -- the eager engine path ----------------------------------------------------

EAGER_MODULES = (
    "horovod_tpu_torch.core.device_reduce", "horovod_tpu_torch.core.objects",
    "horovod_tpu_torch.ops.async_ops", "horovod_tpu_torch.torch",
    "horovod_tpu_torch.torch.compression", "horovod_tpu_torch.torch.mpi_ops",
    "horovod_tpu_torch.torch.optimizer", "horovod_tpu_torch.torch.state",
    "horovod_tpu_torch.tree", "horovod_tpu_torch.relay")


@pytest.mark.parametrize("mod", EAGER_MODULES)
def test_eager_module_is_checked(mod):
    # Walked by the two import checks above, which it passes.
    assert mod in _modules()
    path = os.path.join(REPO, *mod.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) \
        else path + ".py"
    test_no_import_statement_names_jax(path)


def test_eager_modules_alone_import_no_jax_and_the_binding_names_torch():
    # The binding's subpackage is named torch; inside it (absolute
    # imports) "torch" is PyTorch.
    code = ("import json, sys\n"
            f"for m in {EAGER_MODULES!r}: __import__(m)\n"
            "import torch, horovod_tpu_torch.torch.mpi_ops as mo\n"
            "assert mo.torch is torch and hasattr(mo.torch, 'Tensor')\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert not [m for m in json.loads(out.strip().splitlines()[-1])
                if _forbidden(m)]



# -- fault-tolerant training ----------------------------------------------------

FT_MODULES = (
    "horovod_tpu_torch.run", "horovod_tpu_torch.utils.manifest",
    "horovod_tpu_torch.checkpoint", "horovod_tpu_torch.data",
    "horovod_tpu_torch.faults", "horovod_tpu_torch.training",
    "horovod_tpu_torch.callbacks")


@pytest.mark.parametrize("mod", FT_MODULES)
def test_fault_tolerance_module_is_checked(mod):
    # Walked by the two import checks above, which it passes.
    assert mod in _modules()
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    test_no_import_statement_names_jax(path)


def test_fault_tolerance_modules_alone_import_no_jax_and_nothing_of_horovod_tpu():
    code = ("import json, sys\n"
            f"for m in {FT_MODULES!r}: __import__(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert not [m for m in json.loads(out.strip().splitlines()[-1])
                if _forbidden(m)]


def test_launcher_imports_no_torch_and_pins_no_platform():
    # The supervising parent stays a standard-library process, and the
    # children pick their own device.
    code = ("import json, sys\n"
            "import horovod_tpu_torch.run as r\n"
            "env = r._child_env(0, 1, 1, 2, 0, None)\n"
            "print(json.dumps([sorted(sys.modules), env.get('JAX_PLATFORMS'),"
            " env.get('XLA_FLAGS')]))")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    mods, platforms, flags = json.loads(out.strip().splitlines()[-1])
    assert "torch" not in mods and not [m for m in mods if _forbidden(m)]
    assert platforms is None and flags is None


# -- long-context training ------------------------------------------------------

LONGCTX_MODULES = (
    "horovod_tpu_torch.parallel", "horovod_tpu_torch.parallel.ring_attention",
    "horovod_tpu_torch.parallel.ulysses", "horovod_tpu_torch.parallel.context",
    "horovod_tpu_torch.ops.schedule_plan", "horovod_tpu_torch.train_longseq")


@pytest.mark.parametrize("mod", LONGCTX_MODULES)
def test_long_context_module_is_checked(mod):
    # Walked by the two import checks above, which it passes.
    assert mod in _modules()
    parts = mod.split(".")
    path = os.path.join(REPO, *parts) + ".py"
    if not os.path.exists(path):
        path = os.path.join(REPO, *parts, "__init__.py")
    test_no_import_statement_names_jax(path)


def test_long_context_modules_alone_import_no_jax_and_nothing_of_horovod_tpu():
    code = ("import json, sys\n"
            f"for m in {LONGCTX_MODULES!r}: __import__(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert not [m for m in json.loads(out.strip().splitlines()[-1])
                if _forbidden(m)]
