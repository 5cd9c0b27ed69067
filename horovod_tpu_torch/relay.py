"""Aggregator-relay sidecar: ``python -m horovod_tpu_torch.relay`` — the
port's copy of ``horovod_tpu/relay.py``, over the port's own native core
(``core/src/c_api.cc`` ``hvd_relay_run``).

A relay is a tiny non-training process that serves one aggregator group of
the hierarchical coordinator tree (core/src/tree.cc): it gathers its
members' per-tick requests, folds them into one AGG_REQUEST frame for the
root, and fans the root's verdict back out — O(fanout) frames at the root
instead of O(size).  The JAX package's launcher spawns one primary (and
one standby) per group when the tree activates; the port has no launcher
yet, so its relays are placed by hand (``tree.plan`` says how many).

The process BLOCKS in native code until the tree shuts down.  Exit codes:
0 clean shutdown (root broadcast a shutdown round), 1 escalated failure,
2 invalid configuration.

Standby relays (``--standby --peer-host H --peer-port P``) attach to their
primary, mirror its replicated AGG_STATE stream, and promote themselves in
place when the primary dies (docs/fault_tolerance.md "Aggregator
failover").
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.relay",
        description="hierarchical control-plane aggregator relay sidecar")
    ap.add_argument("--agg-id", type=int, required=True,
                    help="aggregator group id (0-based)")
    ap.add_argument("--parent-host", default="127.0.0.1",
                    help="tree root (rank 0) control-plane host")
    ap.add_argument("--parent-port", type=int, required=True,
                    help="tree root control-plane port")
    ap.add_argument("--listen-port", type=int, default=0,
                    help="member-facing listen port (0 = OS-assigned; the "
                         "launcher pre-reserves ports so the agg map can be "
                         "exported before the relays bind)")
    ap.add_argument("--size", type=int, required=True,
                    help="job size (total ranks incl. rank 0)")
    ap.add_argument("--fanout", type=int, required=True,
                    help="members per aggregator group")
    ap.add_argument("--threshold", type=int, default=0,
                    help="tree activation threshold (must match the ranks')")
    ap.add_argument("--epoch", type=int, default=0,
                    help="control-plane membership epoch")
    ap.add_argument("--standby", action="store_true",
                    help="run as the group's standby (requires --peer-*)")
    ap.add_argument("--peer-host", default="",
                    help="standby only: the primary relay's host")
    ap.add_argument("--peer-port", type=int, default=0,
                    help="standby only: the primary relay's member port")
    ap.add_argument("--member-timeout-ms", type=int, default=0,
                    help="member-silence bound (0 = native default)")
    args = ap.parse_args(argv)
    if args.standby and (not args.peer_host or args.peer_port <= 0):
        ap.error("--standby requires --peer-host and --peer-port")

    from horovod_tpu_torch.core import engine as _engine

    return _engine.lib().hvd_relay_run(
        args.agg_id, args.parent_host.encode(), args.parent_port,
        args.listen_port, args.size, args.fanout, args.threshold,
        args.epoch, 1 if args.standby else 0, args.peer_host.encode(),
        args.peer_port, args.member_timeout_ms)


if __name__ == "__main__":
    sys.exit(main())
