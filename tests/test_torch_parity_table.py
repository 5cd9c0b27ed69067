"""The README's parity table against the two trees: every ``.py``, ``.cc``
and ``.h`` file of ``horovod_tpu/`` has a counterpart in
``horovod_tpu_torch/`` or a row of the table, so a file added to the JAX
package cannot go unnoticed; every row names a file that exists on both
sides, or says why the port has none."""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "horovod_tpu")
PORT_DIR = os.path.join(REPO, "horovod_tpu_torch")
HEADING = "### Parity table: `horovod_tpu` → `horovod_tpu_torch`"
NA = "n/a in the torch port: "
# The rows that read n/a: the JAX plumbing and the optax idiom.
EXPECTED_NA = {
    "flax/__init__.py", "keras/__init__.py", "mesh.py",
    "utils/jaxcompat.py", "tensorflow/__init__.py",
    "tensorflow/compression.py", "tensorflow/keras/__init__.py",
    "tensorflow/keras/callbacks.py", "tensorflow/mpi_ops.py",
    "ops/collective_ops.py shard / batch_spec",
    "training.py DistributedState / DistributedEFState / MasterWeightsState",
}


def _jax_files() -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(d, f), JAX_DIR)
        for d, _dirs, fs in os.walk(JAX_DIR) if "__pycache__" not in d
        for f in fs if f.endswith((".py", ".cc", ".h")))


def _table() -> dict[str, str]:
    """JAX-side entry (backticks dropped) -> the port's cell."""
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    assert text.count(HEADING) == 1, "the README lost its parity table"
    rows = {}
    for line in text.split(HEADING, 1)[1].splitlines():
        if line.startswith("#"):
            break
        m = re.match(r"^\| (.+?) \| (.+) \|$", line)
        if m is None or set(m.group(1)) <= {"-", "|"} or \
                m.group(1) == "`horovod_tpu/`":
            continue
        key = m.group(1).replace("`", "")
        assert key not in rows, f"two rows for {key}"
        rows[key] = m.group(2)
    return rows


def test_every_jax_file_has_a_counterpart_or_a_row():
    rows = _table()
    missing = [r for r in _jax_files()
               if not os.path.exists(os.path.join(PORT_DIR, r))
               and r not in rows]
    assert missing == [], (
        f"files of horovod_tpu/ with no port counterpart and no row of "
        f"the README's parity table: {missing}")


def test_table_lists_every_jax_file():
    rows = _table()
    assert [r for r in _jax_files() if r not in rows] == []
    stale = [k for k in rows if k.endswith((".py", ".cc", ".h"))
             and not os.path.exists(os.path.join(JAX_DIR, k))]
    assert stale == [], f"rows for files horovod_tpu/ no longer has: {stale}"


def test_every_counterpart_exists():
    for key, cell in _table().items():
        if cell.startswith(NA):
            continue
        port = re.match(r"^`([^`]+)`", cell)
        assert port, (key, cell)
        assert os.path.isfile(os.path.join(PORT_DIR, port.group(1))), \
            (key, cell)
        if port.group(1) != key:   # a moved file says where and why
            assert "moved" in cell, (key, cell)


def test_na_rows_are_the_jax_plumbing_with_reasons():
    rows = _table()
    na = {k: c for k, c in rows.items() if c.startswith(NA)}
    assert set(na) == EXPECTED_NA
    for key, cell in na.items():
        assert len(cell) > len(NA) + 20, f"{key}: no reason given"
        if key.endswith((".py", ".cc", ".h")):
            assert not os.path.exists(os.path.join(PORT_DIR, key)), key


def test_na_symbols_exist_in_the_jax_package():
    with open(os.path.join(JAX_DIR, "ops", "collective_ops.py")) as f:
        ops = f.read()
    with open(os.path.join(JAX_DIR, "training.py")) as f:
        training = f.read()
    for name in ("shard", "batch_spec"):
        assert re.search(rf"^def {name}\(", ops, re.M), name
    for name in ("DistributedState", "DistributedEFState",
                 "MasterWeightsState"):
        assert re.search(rf"^class {name}\b", training, re.M), name


# -- the entry points: examples/ -> horovod_tpu_torch --------------------------

EXAMPLES_DIR = os.path.join(REPO, "examples")
EXAMPLES_HEADING = "### Parity table: `examples/` → `horovod_tpu_torch`"
EXAMPLES_NA = {"tensorflow_mnist.py", "tf_keras_mnist.py"}


def _examples() -> list[str]:
    return sorted(f for f in os.listdir(EXAMPLES_DIR)
                  if f.endswith(".py") and f != "__init__.py")


def _examples_table() -> dict[str, str]:
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    assert text.count(EXAMPLES_HEADING) == 1, \
        "the README lost its parity table of the examples"
    rows = {}
    for line in text.split(EXAMPLES_HEADING, 1)[1].splitlines():
        if line.startswith("#"):
            break
        m = re.match(r"^\| `([^`]+)` \| (.+) \|$", line)
        if m is None or m.group(1) == "examples/":
            continue
        assert m.group(1) not in rows, f"two rows for {m.group(1)}"
        rows[m.group(1)] = m.group(2)
    return rows


def _counterpart(script: str) -> str:
    """The port's module of the same name (a ``jax_`` prefix dropped)."""
    name = script[len("jax_"):] if script.startswith("jax_") else script
    return os.path.join(PORT_DIR, "examples", name)


def test_every_example_has_a_counterpart_or_a_row():
    rows = _examples_table()
    missing = [s for s in _examples()
               if not os.path.exists(_counterpart(s)) and s not in rows]
    assert missing == [], (
        f"scripts of examples/ with no module in horovod_tpu_torch/"
        f"examples/ and no row of the README's parity table: {missing}")


def test_examples_table_lists_every_script_and_no_other():
    rows = _examples_table()
    assert sorted(rows) == _examples()


def test_examples_rows_name_modules_that_exist():
    for script, cell in _examples_table().items():
        if cell.startswith(NA):
            assert script in EXAMPLES_NA, (script, cell)
            assert len(cell) > len(NA) + 20, f"{script}: no reason given"
            continue
        port = re.match(r"^`([^`]+)`", cell)
        assert port, (script, cell)
        assert os.path.isfile(os.path.join(PORT_DIR, port.group(1))), \
            (script, cell)
        if port.group(1).startswith("examples/"):
            assert os.path.join(PORT_DIR, port.group(1)) == \
                _counterpart(script), (script, cell)
    assert {s for s, c in _examples_table().items()
            if c.startswith(NA)} == EXAMPLES_NA
