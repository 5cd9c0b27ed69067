"""The harness finds everything ``BENCHMARK.json`` names by name, the
file keeps to the benchmark's rules, and a new cell, traffic mix and
per-layer metric need new files only."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil

import pytest

from perfbench import harness, run
from perfbench.tests import small

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_is_found():
    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        family = cfg["family"]
        assert importlib.import_module(f"perfbench.models.{family}").build
        assert importlib.import_module(
            f"perfbench.reference.{family}").train
    for w in BENCH["workloads"]:
        traffic = harness.traffic(w["traffic"])
        assert harness.kind(traffic["kind"]).run
        assert harness.limits(w["name"]), f"no limits for {w['name']}"
        assert harness.metrics_of(w["name"], "per_layer", BENCH)
        e2e = {m["name"] for m in
               harness.metrics_of(w["name"], "end_to_end", BENCH)}
        assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["per_layer"]:
        assert callable(harness.metric(m["name"]).read)


def test_rules_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", cells):
            reported = {x["name"] for x in
                        harness.metrics_of(w, "end_to_end", BENCH)}
            assert m["moves"] in reported, (m["name"], w)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_mix_and_metric_are_files_only(tmp_path, monkeypatch):
    """A throwaway cell with its own traffic mix, limits and per-layer
    metric runs end to end, found by name, with no file of the harness
    edited."""
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(harness.HERE, d), tmp_path / d)
    cfg, traffic = small.sizes("deepseek-llm-7b.train.s4096")
    (tmp_path / "configs" / "tiny-decoder.json").write_text(
        json.dumps({**cfg, "name": "tiny-decoder"}))
    (tmp_path / "traffic" / "train.s32.json").write_text(
        json.dumps({**traffic, "seq_len": 32}))
    (tmp_path / "limits" / "tiny-decoder.train.s32.json").write_text(
        json.dumps({k: {"limit": 10.0} for k in
                    ("loss_gap", "grad_norm_gap", "change_norm_gap")}))
    (tmp_path / "metrics" / "steps_in_window.train.py").write_text(
        "def read(t):\n    return float(t['steps'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "tiny-decoder.train.s32", "config": "tiny-decoder",
        "traffic": "train.s32", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "steps_in_window.train", "unit": "steps",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": "train_tokens_per_s",
        "workloads": ["tiny-decoder.train.s32"]})
    bench["end_to_end"][0]["workloads"].append("tiny-decoder.train.s32")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    out = run.execute("tiny-decoder.train.s32", 2 ** 31 + 3, 0.3, True,
                      device="cpu", bench=bench)
    assert out["result"]["metrics"]["steps_in_window.train"]["value"] >= 1
    assert out["result"]["correct"] is True


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_small_on_the_cpu(cell):
    from horovod_tpu_torch.ops import schedule_plan

    # The planner agrees its device probe across the ranks once a process:
    # a four-rank cell after another cell in this process plans anew.
    schedule_plan._reset_for_tests()
    cfg, traffic = small.sizes(cell)
    out = run.execute(cell, 2 ** 32 + 17, 0.3, False, device="cpu",
                      cfg=cfg, traffic=traffic)
    res = out["result"]
    names = {m["name"] for m in harness.metrics_of(cell, "end_to_end")}
    assert set(res["metrics"]) == names
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] is not None for c in out["checks"].values())
    assert list(json.loads(json.dumps({**res, "checks": out["checks"]})))[
        -1] == "checks"
