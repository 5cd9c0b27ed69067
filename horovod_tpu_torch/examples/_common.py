"""What the example entry points share: the ``--device`` flag, the
synthetic MNIST stand-in and the default checkpoint directory."""

from __future__ import annotations

import os
import tempfile

import numpy as np


def add_device(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def synthetic_mnist(n: int = 4096, seed: int = 0):
    """Deterministic stand-in for the MNIST download, the JAX examples'
    own: ``[n, 28, 28, 1]`` float32 images and int32 labels."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) * 10).astype(np.int32) % 10
    return x, y


def scratch_dir(name: str) -> str:
    """A default checkpoint directory under the process's temporary
    directory."""
    return os.path.join(tempfile.gettempdir(), name)

