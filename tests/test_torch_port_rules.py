"""Rules of the PyTorch/CUDA port: no JAX and nothing of ``horovod_tpu`` in
``horovod_tpu_torch``; entry points on CUDA unless asked for the CPU; a CUDA
tensor launches its kernel or raises, and a build failure raises."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch
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


def test_cuda_flash_wrapper_raises_on_requires_grad(monkeypatch):
    # Treat these CPU tensors as CUDA ones: the wrapper must refuse to run
    # a forward whose backward is not ported, not fall back.
    monkeypatch.setattr(tfa, "_on_cuda", lambda t: True)
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64)
    with pytest.raises(RuntimeError, match="backward"):
        tfa.flash_attention(q, k, v)
    launches = tfa.KERNEL.launches
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(*(torch.randn(1, 8, 2, 16) for _ in range(3)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(*(torch.randn(1, 8, 2, 64).half()
                              for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q.detach(), k, v)
    assert tfa.KERNEL.launches == launches


def test_cuda_rmsnorm_wrapper_raises_on_requires_grad(monkeypatch):
    monkeypatch.setattr(trn, "_on_cuda", lambda t: True)
    x = torch.randn(4, 32)
    scale = torch.ones(32, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        trn.rms_norm(x, scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trn.rms_norm(x.half(), scale.detach())


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


def test_library_name_follows_source_and_flags():
    k = _build.KERNELS["flash_fwd"]
    path = k.library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert os.path.basename(path).startswith("flash_fwd-")
    assert sorted(_build.KERNELS) == ["flash_fwd", "rmsnorm_fwd"]
    for k in _build.KERNELS.values():
        assert os.path.exists(k.source)
