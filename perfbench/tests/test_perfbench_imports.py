"""No process of the benchmark holds JAX or the JAX package, and the
plain references hold nothing of the program: top-level names compared
whole."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT


def test_names_are_compared_whole():
    mods = {"horovod_tpu_torch": 1, "horovod_tpu_torch.ops": 1,
            "jaxtyping": 1, "flax_like": 1, "torch": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"horovod_tpu": 1, "horovod_tpu.ops.flash": 1, "jax": 1,
                 "jaxlib.xla_client": 1, "flax.linen": 1})
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "horovod_tpu", "horovod_tpu.ops.flash", "jax",
        "jaxlib.xla_client"]
    with pytest.raises(SystemExit):
        harness.check_imports(mods)
    assert harness.forbidden_modules(
        {"horovod_tpu_torch.x": 1}, names=(harness.PROGRAM,)) == \
        ["horovod_tpu_torch.x"]


def _loaded(code: str) -> list[str]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    top = _loaded(
        "from perfbench import run\n"
        "from perfbench.tests import small\n"
        "cfg, tr = small.sizes('deepseek-llm-7b.train.s4096')\n"
        "run.execute('deepseek-llm-7b.train.s4096', 5, 0.2, False,"
        " device='cpu', cfg=cfg, traffic=tr)\n")
    assert "horovod_tpu_torch" in top
    assert not set(top) & set(harness.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    top = _loaded("import perfbench.reference.decoder\n"
                  "import perfbench.reference.resnet\n"
                  "import perfbench.compare, perfbench.counts\n")
    assert harness.PROGRAM not in top
    assert not set(top) & set(harness.FORBIDDEN)
