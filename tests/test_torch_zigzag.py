"""The port's zigzag ring attention against the JAX package's on the same
numpy inputs, forward and backward, at widths 2 and 4, causal and not: the
JAX function under ``shard_map`` over the suite's virtual CPU devices (the
Pallas kernels in interpret mode), the port in gloo processes on the CPU
(the flash wrappers' plain versions).  Both take the zigzag permutation of
the same global q, k, v and output cotangent; the tolerances are the JAX
zigzag test's own (``tests/test_zigzag.py``): 2e-5 on outputs, 5e-4 on
gradients.  The harness is ``tests/test_torch_ring_attention.py``'s.
"""

import pytest

from horovod_tpu import parallel as jpar
from test_torch_ring_attention import (BLOCK, GRAD_TOL, OUT_TOL, S,
                                       _close, _inputs, gathered,
                                       jax_fwd_bwd, run_workers)


@pytest.fixture(scope="module", params=[2, 4])
def port(request, tmp_path_factory):
    n = request.param
    return n, run_workers(n, ("zigzag",),
                          tmp_path_factory.mktemp(f"zigzag{n}"))


@pytest.mark.parametrize("causal", [True, False])
def test_zigzag_matches_jax_forward_and_backward(hvd, port, causal):
    n, outs = port
    q, k, v, dout = _inputs()
    zig = jpar.zigzag_permutation(S, n)
    want = jax_fwd_bwd(
        lambda q, k, v: jpar.zigzag_ring_flash_attention(
            q, k, v, "sp", causal, BLOCK, BLOCK),
        n, tuple(a[:, zig] for a in (q, k, v)), dout[:, zig])
    for i in range(4):
        _close(gathered(outs, f"zigzag.{causal}", n, i), want[i],
               OUT_TOL if i == 0 else GRAD_TOL)


def test_zigzag_exchanges(port):
    # Per causal setting: n-1 K/V exchanges forward; n-1 K/V and n dk/dv
    # (all four halves in one exchange) backward.
    n, outs = port
    for r in range(n):
        assert outs[r]["exchange"]["exchanges"] == 2 * ((n - 1)
                                                        + (2 * n - 1))
