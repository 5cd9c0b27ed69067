"""Explicit-state model checking for the control-plane protocol.

The control plane is now three protocols composed: the rank-0 star
(REQUEST/RESPONSE lockstep), elastic membership (RECONFIG/JOIN/JOIN_ACK
epochs, STANDBY/STATE succession), and serving drain (QUIT ->
``serving.drained``).  Every protocol bug shipped so far — the
completion lost on a reconfig-aborted ``serving.tick``, the QUIT drain
wedge, the ``join(old_rank=-1)`` sentinel collision — was an
*interleaving* bug: each machine was locally sensible and the composition
wedged or lost data only under one delivery order no soak happened to hit.

This subpackage checks the composition the way production control planes
are checked: pure-Python models of each state machine (machines.py), a
deterministic scheduler that enumerates every interleaving of message
delivery, crash, partition, and join events up to a bounded depth
(checker.py — BFS with state hashing, plus a seeded random walk for
deeper runs), and safety invariants as predicates (invariants.py).

Two things pin the model to THIS codebase rather than a toy:

* wire.py mirrors core/src/message.cc byte-for-byte and pins every
  FrameType against golden vectors in tests/golden/frames/ (also encoded
  from C++ via the ``hvd_frame_golden`` c_api hook), so the vocabulary the
  model speaks is the vocabulary on the wire;
* replay.py converts any counterexample trace into the
  ``HVD_TPU_FAULT_WIRE_*`` / faults.py schedule that reproduces it
  against the real engine.

Run ``python -m horovod_tpu_torch.analysis.protocol`` (the gate's
model-check leg, ``python -m horovod_tpu_torch.core.check``) for the
bounded exhaustive sweep.
"""

from horovod_tpu_torch.analysis.protocol.checker import (  # noqa: F401
    CheckResult, Violation, check_bfs, check_walk, replay_trace)
from horovod_tpu_torch.analysis.protocol.machines import (  # noqa: F401
    ElasticModel, ServingDrainModel, TreeModel)
