"""Input-pipeline sharding helpers — counterpart of ``horovod_tpu/data.py``:
the DistributedSampler pattern, a background loader, and prefetch onto
the card.

The reference's contract is "shard your data by rank"
(``DistributedSampler(num_replicas=hvd.size(), rank=hvd.rank())``):

* ``shard_arrays`` / ``ShardedBatches`` give each process its strided
  slice of the dataset, in the same index order as the JAX package's for
  the same arrays, rank, size, seed and epoch.  The port runs one card
  per process, so a batch is ``batch_per_chip`` rows;
* ``BackgroundLoader`` runs a batch producer on a thread ahead of the
  training loop;
* ``prefetch_to_device`` copies upcoming batches from pinned host memory
  to the card on a side CUDA stream, so the copy of batch N+1 rides under
  the compute of batch N.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from horovod_tpu_torch import basics


def shard_arrays(*arrays, drop_remainder: bool = True):
    """Return each array's slice for this process (strided, like
    DistributedSampler without shuffle).

    With ``drop_remainder`` every process gets the same length (required
    for lockstep collectives: mismatched step counts hang them).
    """
    rank, size = basics.rank(), basics.size()
    outs = []
    n_min = min(len(a) for a in arrays) if arrays else 0
    per = n_min // size if drop_remainder else None
    for a in arrays:
        s = a[rank::size]
        outs.append(s[:per] if per is not None else s)
    return outs[0] if len(outs) == 1 else tuple(outs)


class ShardedBatches:
    """Iterate epoch batches of a process-sharded dataset.

    ``batch_per_chip`` follows the reference's per-accelerator batch-size
    convention; the port drives one card per process, so it is the
    process's batch.  Each epoch reshuffles with
    ``np.random.RandomState(seed + epoch)``, identically across restarts.
    """

    def __init__(self, *arrays: Sequence, batch_per_chip: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        self.arrays = shard_arrays(*arrays, drop_remainder=drop_remainder)
        if len(arrays) == 1:
            self.arrays = (self.arrays,)
        self.batch = batch_per_chip
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.arrays[0]) // self.batch

    def __iter__(self) -> Iterator[tuple]:
        n = len(self.arrays[0])
        idx = np.arange(n)
        if self.shuffle:
            # DistributedSampler.set_epoch's convention: reshuffle per
            # epoch, deterministically, identically across restarts.
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        for lo in range(0, n - self.batch + 1, self.batch):
            sel = idx[lo:lo + self.batch]
            yield tuple(np.asarray(a)[sel] for a in self.arrays)


class BackgroundLoader:
    """Run a batch producer on a daemon thread behind a bounded queue.

    Wraps any iterable (e.g. :class:`ShardedBatches`, or a generator doing
    real IO): production runs ahead of consumption up to ``depth``
    batches, so host-side loading overlaps device steps.

    A producer exception is re-raised on the consumer thread at the point
    of ``next()`` — never swallowed.  Iterating again restarts the source
    (a new epoch for ``ShardedBatches``).  A consumer that abandons an
    iteration (``close()``, or the generator collected) stops the thread.
    """

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._source = source
        self._depth = depth

    def __len__(self) -> int:
        return len(self._source)  # type: ignore[arg-type]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # Every producer put honors the stop event — including the
            # terminal DONE/exception ones, or an abandoning consumer with
            # a full queue would strand this thread (and its queued
            # batches) forever.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for item in self._source:
                    if not put_or_stop(item):
                        return
                put_or_stop(self._DONE)
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                put_or_stop(e)

        t = threading.Thread(target=produce, name="hvd-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def _map(fn, batch):
    """``fn`` over every leaf of a batch: a tensor or array, or a tuple,
    list or dict of them."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Double-buffer host batches onto ``device`` (default: this process's
    card, ``basics.device()`` after ``init``, else ``cuda``).

    Up to ``size`` upcoming batches are in flight before the current one
    is yielded.  A batch is a tensor or numpy array, or a tuple, list or
    dict of them; other leaves (a step index, say) pass through as they
    are.  On a CUDA device every array is staged in pinned host memory and
    copied on a side stream; the batch yielded is safe to read on the
    consumer's stream: that stream waits for the event recorded after the
    batch's copies, and every tensor is recorded on it so its memory is
    not reused before the consumer is done with it.  On the CPU it is a
    plain pass-through to the device.
    """
    if size < 1:
        raise ValueError("size must be >= 1")
    if device is None:
        device = basics.device() if basics.is_initialized() else "cuda"
    dev = torch.device(device)
    it = iter(iterator)
    buf: list = []
    side = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("prefetch_to_device: no CUDA device")
        side = torch.cuda.Stream(device=dev)

    def copy(x):
        if not _is_array(x):
            return x
        t = _as_tensor(x)
        if side is None:
            return t.to(dev)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            if side is None:
                buf.append(_map(copy, batch))
                continue
            with torch.cuda.stream(side):
                moved = _map(copy, batch)
                landed = torch.cuda.Event()
                landed.record(side)
            buf.append((moved, landed))

    enqueue(size)
    while buf:
        out = buf.pop(0)
        if side is not None:
            out, landed = out
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(landed)
            _map(lambda t: t.record_stream(consumer)
                 if isinstance(t, torch.Tensor) else None, out)
        yield out
        enqueue(1)
