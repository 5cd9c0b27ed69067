"""The protocol state machines, one model per composition under test.

* ServingDrainModel (_serving.py) — star + elastic + serving drain: the
  composition that shipped two drain bugs.  Pre-fix flags re-derive
  both as counterexamples; all-fixed flags are the model-check
  sweep.
* ElasticModel (_elastic.py) — epochs, standby succession, split-brain
  fencing, JOIN tickets and the old_rank=-1 sentinel collision.
* TreeModel (_tree.py) — the relay-tier spec: root death
  in tree mode and RECONFIG with a live relay tier, with the three
  replication-ordering rules the checker proves load-bearing.

Every model implements the checker.py scheduler interface plus
``wire_frames(state, event)`` returning the real (frame_name,
payload_struct, epoch) triples the event puts on the wire — encoded and
decoded through wire.py by the conformance tests, so the model can only
speak frames message.cc accepts.
"""

from horovod_tpu_torch.analysis.protocol._elastic import (  # noqa: F401
    ElasticModel, EState)
from horovod_tpu_torch.analysis.protocol._serving import (  # noqa: F401
    FleetState, ServingDrainModel, WState)
from horovod_tpu_torch.analysis.protocol._tree import (  # noqa: F401
    MS, RelayS, TreeModel, TState)
