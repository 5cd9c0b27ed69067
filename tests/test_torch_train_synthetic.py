"""``python -m horovod_tpu_torch.train_synthetic`` on the CPU: the JAX
example's CLI (``examples/jax_synthetic_benchmark.py``) with each model of
the reference's table at its full widths on small images, one process and
two (gloo, under the port's launcher), its JSON line, the fusion sweep and
the compression reaching ``DistributedOptimizer``."""

import json

import numpy as np
import pytest
import torch

from _timing import scaled
from horovod_tpu_torch import train_synthetic as ts

FEW = ["--batch-size", "2", "--num-warmup-batches", "0", "--num-iters",
       "1", "--num-batches-per-iter", "1"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's CPU work, as the suite runs it:
    several workers share the host's cores.  The worker's setting is put
    back after the file."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def world1(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS",
                 "HOROVOD_FUSION_THRESHOLD"):
        monkeypatch.delenv(name, raising=False)
    yield


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_canonical_sizes_and_the_cli():
    assert ts.image_size("InceptionV3") == 299
    assert ts.image_size("VGG16") == ts.image_size("ResNet101") == 224
    assert ts.image_size("VGG19", 64) == 64
    args = ts.parse_args([])
    assert (args.model, args.batch_size, args.compression, args.sweep) == \
        ("ResNet50", 32, "none", False)
    assert (args.num_warmup_batches, args.num_iters,
            args.num_batches_per_iter) == (10, 10, 10)
    assert sorted(ts.MODELS) == ["InceptionV3", "ResNet101", "ResNet152",
                                 "ResNet50", "VGG16", "VGG19"]
    with pytest.raises(SystemExit):
        ts.parse_args(["--model", "AlexNet"])
    m = ts.build_model("VGG16", "meta")
    assert m.dropout_rate == 0.0 and m.dense[0].in_features == 7 * 7 * 512


@pytest.mark.parametrize("model,size", [("ResNet50", 32), ("VGG16", 32),
                                        ("InceptionV3", 75)])
def test_cli_trains_each_model_on_one_cpu_process(world1, capsys, model,
                                                  size):
    assert ts.main(["--device", "cpu", "--model", model, "--image-size",
                    str(size), *FEW]) == 0
    out = capsys.readouterr().out
    assert "Img/sec per card:" in out and "Total img/sec on 1 card(s):" in out
    (rec,) = _json_lines(out)
    assert rec["model"] == model and rec["image_size"] == size
    assert rec["processes"] == 1 and rec["device"] == "cpu"
    assert rec["params"] == sum(p.numel() for p in ts.build_model(
        model, "meta", size=size).parameters())
    assert len(rec["losses"]) == 1 and np.isfinite(rec["losses"][0])
    assert rec["img_per_s"] > 0 and rec["step_ms"] > 0
    assert rec["overlap_plan"]["reason"].startswith("width-1 bypass")
    assert rec["max_memory_allocated"] is None and rec["nvidia_smi"] is None


def test_compression_reaches_the_optimizer(world1):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    buckets = {}
    try:
        for compression in ts.COMPRESSIONS:
            args = ts.parse_args(["--model", "ResNet50", "--image-size", "32",
                                  "--compression", compression, *FEW])
            rec = ts.run(args, 2**20, stage_sizes=(1, 1), num_filters=64,
                         num_classes=10)
            assert rec["compression"] == compression
            assert rec["fusion_threshold_bytes"] == 2**20
            assert all(np.isfinite(rec["losses"]))
            buckets[compression] = rec["fusion_buckets"]
    finally:
        hvd.shutdown()
    # ~4 MB of f32 gradients in 1 MiB buckets; the 16-bit wires halve the
    # bytes and so need fewer; the int8 wire packs none.
    assert buckets["none"] > buckets["fp16"] == buckets["bf16"] > \
        buckets["int8"] == 0, buckets


def test_sweep_cli_runs_every_threshold(world1, capsys):
    assert ts.main(["--device", "cpu", "--model", "ResNet50", "--image-size",
                    "32", "--sweep", *FEW]) == 0
    out = capsys.readouterr().out
    recs = _json_lines(out)
    assert [r["fusion_threshold_bytes"] for r in recs] == \
        [mib * 2**20 for mib in ts.SWEEP_MIB]
    for mib in ts.SWEEP_MIB:
        assert f"fusion_threshold={mib}MiB -> " in out
    buckets = [r["fusion_buckets"] for r in recs]
    # ResNet-50's 102 MB of f32 gradients, the width-1 bypass: one fused
    # set, many flat buffers at 1 MiB, one at 256 MiB.
    assert buckets == sorted(buckets, reverse=True) and buckets[0] > \
        buckets[-1] == 1, buckets


def _sweep_worker(rank, store, results):
    import horovod_tpu_torch as hvd

    torch.set_num_threads(2)
    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        args = ts.parse_args(["--model", "ResNet50", "--image-size", "32",
                              *FEW])
        recs = [ts.run(args, mib * 2**20, stage_sizes=(1, 1),
                       num_filters=128, num_classes=10)
                for mib in ts.SWEEP_MIB]
        results.put((rank, json.dumps(recs)))
    finally:
        hvd.shutdown()


def test_sweep_on_two_processes_changes_the_buckets_with_the_threshold(
        tmp_path, world1):
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_sweep_worker,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, blob = results.get(timeout=scaled(180))
            outs[rank] = json.loads(blob)
    except queue.Empty:
        pytest.fail(f"ranks {sorted(outs)} reported, exit codes "
                    f"{[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank in (0, 1):
        recs = outs[rank]
        for r in recs:
            assert r["processes"] == 2 and all(np.isfinite(r["losses"]))
            plan = r["overlap_plan"]
            assert plan["width"] == 2 and plan["chained"], plan
        buckets = [r["fusion_buckets"] for r in recs]
        # ~17 MB of gradients in the planner's chained buckets: more flat
        # buffers at 1 MiB than chained buckets, one a chained bucket from
        # 8 MiB up.
        depth = recs[0]["overlap_plan"]["chain_depth"]
        assert buckets[0] > depth and buckets[1:] == [depth] * 3, buckets
    # Both ranks trained the same averaged step.
    assert [r["losses"] for r in outs[0]] != [] and \
        outs[0][-1]["fusion_buckets"] == outs[1][-1]["fusion_buckets"]
