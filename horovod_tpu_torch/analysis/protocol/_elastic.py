"""Elastic membership / coordinator-succession model.

Four machines: the coordinator (rank 0), its designated standby (rank 1,
pre-bound listener, fed CoordState deltas over STATE frames), a plain
worker (rank 2), and one joiner knocking with a JOIN frame.  Faults:
coordinator SIGKILL or a partition that isolates it (it keeps running and
still believes it is the coordinator — the split-brain window).

Verified rules (the fixed defaults) and the bug knobs that break them:

* ``promotion_bumps_epoch=False`` — the promoted standby speaks the
  replicated epoch instead of replicated+1; after a partition both sides
  serve the SAME epoch -> ``single-coordinator`` violation.  The epoch
  bump is what lets FrameHeader.flags fence the loser off.
* ``clamp_join_id=False`` — the joiner sends JOIN{id=-1} (a fresh
  autoscaled replica has no prior seat).  The native PollJoinRequest
  caller reads negative ids as "no join pending", so the connection is
  parked unserviced forever -> quiescence violation with a healthy
  coordinator (the serving/worker.py ``old_rank=0`` clamp).
* ``idempotent_reissue=False`` — a retried JOIN knock is admitted again
  instead of re-issuing the same ticket: two seats for one joiner ->
  ``ticket-single-use`` violation.

Also holds ``standby-not-ahead`` (STATE replication lags, never leads)
and ``epoch-monotonic`` across every interleaving.
"""

from __future__ import annotations

from typing import NamedTuple

from horovod_tpu_torch.analysis.protocol import wire
from horovod_tpu_torch.analysis.protocol.invariants import (
    epoch_never_regressed, single_live_coordinator, standby_not_ahead,
    ticket_single_use)

JOINER_ID = 7  # the relaunched replica's wire id once clamped


class EState(NamedTuple):
    # coordinator (rank 0)
    c_alive: bool
    c_isolated: bool       # partitioned: running, unreachable, unfenced
    c_epoch: int
    c_seq: int             # authoritative progress (verifier/LRU deltas)
    c_joins: int
    # standby (rank 1)
    s_promoted: bool
    s_epoch: int           # epoch it speaks once promoted
    rep_epoch: int         # CoordState replica, fed by STATE frames
    rep_seq: int
    rep_joins: int
    # worker (rank 2)
    w_epoch: int
    # joiner
    j_status: str          # outside | knocked | parked | member
    j_epoch: int
    j_rank: int
    j_knocks: int
    # shared
    tickets: tuple         # (epoch, rank, joiner_id) seats ever issued
    state_link: tuple      # coordinator -> standby STATE frames (FIFO)
    join_inbox: tuple      # JOIN frames at the acting coordinator
    ack_link: tuple        # JOIN_ACK frames to the joiner
    w_link: tuple          # RECONFIG frames to the worker
    fault_budget: int
    faults_used: int
    detect_pending: bool
    epoch_regressed: bool

    def coordinators(self):
        if self.c_alive:
            yield ("coordinator", self.c_epoch)
        if self.s_promoted:
            yield ("promoted-standby", self.s_epoch)

    def replication_pairs(self):
        # Only while the standby is still a replica: once promoted it IS
        # the authority and may legitimately run ahead of a dead/fenced
        # primary's last state.
        if self.c_alive and not self.s_promoted:
            yield ("coord-seq", self.c_seq, self.rep_seq)
            yield ("coord-epoch", self.c_epoch, self.rep_epoch)
            yield ("coord-joins", self.c_joins, self.rep_joins)


class ElasticModel:
    """See module docstring; all-True flags model the code as shipped."""

    def __init__(self, max_seq: int = 2, max_knocks: int = 2,
                 faults: int = 1, promotion_bumps_epoch: bool = True,
                 clamp_join_id: bool = True,
                 idempotent_reissue: bool = True) -> None:
        self.max_seq = max_seq
        self.max_knocks = max_knocks
        self.faults = faults
        self.promotion_bumps_epoch = promotion_bumps_epoch
        self.clamp_join_id = clamp_join_id
        self.idempotent_reissue = idempotent_reissue
        self.invariants = [
            ("single-coordinator", single_live_coordinator),
            ("ticket-single-use", ticket_single_use),
            ("standby-not-ahead", standby_not_ahead),
            ("epoch-monotonic", epoch_never_regressed),
        ]

    def initial(self) -> EState:
        return EState(True, False, 0, 0, 0,
                      False, 0, 0, 0, 0,
                      0,
                      "outside", 0, -1, 0,
                      (), (), (), (), (),
                      self.faults, 0, False, False)

    def _acting_coord(self, s: EState) -> str | None:
        """Who services join_inbox: a reachable unpromoted coordinator, or
        the promoted standby."""
        if s.s_promoted:
            return "standby"
        if s.c_alive and not s.c_isolated:
            return "coord"
        return None

    def events(self, s: EState) -> list[tuple]:
        evs: list[tuple] = []
        if s.c_alive and not s.c_isolated:
            if s.c_seq < self.max_seq:
                evs.append(("progress",))
            if not s.state_link and not s.s_promoted and \
                    (s.c_epoch, s.c_seq, s.c_joins) != \
                    (s.rep_epoch, s.rep_seq, s.rep_joins):
                evs.append(("replicate",))
        if s.state_link:
            evs.append(("deliver_state",))
        if s.fault_budget > 0 and s.c_alive and not s.c_isolated:
            evs.append(("fail_coord", "crash"))
            evs.append(("fail_coord", "partition"))
        if s.detect_pending and not s.s_promoted:
            evs.append(("promote",))
        if s.c_alive and s.c_isolated:
            evs.append(("abort_old_coord",))
        if s.w_link:
            evs.append(("deliver_reconfig",))
        if s.j_status in ("outside", "knocked") and \
                s.j_knocks < self.max_knocks and \
                self._acting_coord(s) is not None:
            evs.append(("knock",))
        if s.join_inbox and self._acting_coord(s) is not None:
            evs.append(("poll_join",))
        if s.ack_link:
            evs.append(("deliver_ack",))
        return evs

    def apply(self, s: EState, ev: tuple) -> EState:
        return self._apply(s, ev, collect=False)[0]

    def wire_frames(self, s: EState, ev: tuple) -> list[tuple]:
        return self._apply(s, ev, collect=True)[1]

    def truncated(self, s: EState) -> bool:
        return False

    def is_optional(self, ev: tuple) -> bool:
        # Faults may never fire and the relaunched replica may never
        # knock; a wedge with either budget unspent is still a wedge.
        return ev[0] in ("fail_coord", "knock")

    def quiescent_violation(self, s: EState) -> str | None:
        if s.j_status in ("knocked", "parked") and s.faults_used == 0:
            return (f"joiner {s.j_status} with a healthy coordinator the "
                    f"whole trace: JOIN never serviced (negative-id "
                    f"sentinel collision)")
        if s.c_alive and s.c_isolated:
            return "isolated old coordinator never aborted (MIN_SIZE)"
        return None

    # -- transitions --------------------------------------------------------

    def _apply(self, s: EState, ev: tuple, collect: bool):
        frames: list[tuple] = []
        kind = ev[0]
        if kind == "progress":
            s = s._replace(c_seq=s.c_seq + 1)
        elif kind == "replicate":
            if collect:
                frames.append(("STATE", wire.CoordState(
                    epoch=s.c_epoch, joins_admitted=s.c_joins,
                    verify_checked=s.c_seq), s.c_epoch))
            s = s._replace(state_link=s.state_link
                           + ((s.c_epoch, s.c_seq, s.c_joins),))
        elif kind == "deliver_state":
            (e, seq, joins), rest = s.state_link[0], s.state_link[1:]
            if e < s.rep_epoch:
                # stale_epoch fencing: a delta queued before a (synchronously
                # replicated) epoch bump must not roll the replica back
                s = s._replace(state_link=rest)
            else:
                s = s._replace(rep_epoch=e, rep_seq=seq, rep_joins=joins,
                               state_link=rest)
        elif kind == "fail_coord":
            if ev[1] == "crash":
                s = s._replace(c_alive=False, state_link=(), join_inbox=())
            else:
                s = s._replace(c_isolated=True)
            s = s._replace(fault_budget=s.fault_budget - 1,
                           faults_used=s.faults_used + 1,
                           detect_pending=True)
        elif kind == "promote":
            epoch = s.rep_epoch + (1 if self.promotion_bumps_epoch else 0)
            regressed = s.epoch_regressed or epoch < s.rep_epoch
            if collect:
                frames.append(("RECONFIG", wire.ReconfigInfo(
                    epoch=epoch, new_size=2, failed_rank=0,
                    cause="heartbeat_timeout", new_ranks=(-1, 0, 1),
                    new_coord_rank=1, new_coord_host="127.0.0.1",
                    new_coord_port=23456), epoch))
            s = s._replace(s_promoted=True, s_epoch=epoch,
                           detect_pending=False, epoch_regressed=regressed,
                           w_link=s.w_link + (("RECONFIG", epoch),))
        elif kind == "abort_old_coord":
            # Below the survivable floor alone: exit 75, split-brain closed.
            s = s._replace(c_alive=False, c_isolated=False)
        elif kind == "deliver_reconfig":
            (_, epoch), rest = s.w_link[0], s.w_link[1:]
            regressed = s.epoch_regressed or epoch < s.w_epoch
            s = s._replace(w_epoch=max(s.w_epoch, epoch), w_link=rest,
                           epoch_regressed=regressed)
        elif kind == "knock":
            wire_id = JOINER_ID if self.clamp_join_id else -1
            if collect:
                frames.append(("JOIN", wire.Join(id=max(0, wire_id)
                                                 if self.clamp_join_id
                                                 else wire_id), 0))
            s = s._replace(j_status="knocked", j_knocks=s.j_knocks + 1,
                           join_inbox=s.join_inbox + (wire_id,))
        elif kind == "poll_join":
            s = self._poll_join(s, frames if collect else None)
        elif kind == "deliver_ack":
            (epoch, rank), rest = s.ack_link[0], s.ack_link[1:]
            s = s._replace(j_status="member", j_epoch=epoch, j_rank=rank,
                           ack_link=rest)
        else:
            raise ValueError(f"unknown event {ev}")
        return s, frames

    def _poll_join(self, s: EState, frames) -> EState:
        wire_id, rest = s.join_inbox[0], s.join_inbox[1:]
        s = s._replace(join_inbox=rest)
        if wire_id < 0:
            # Pre-fix PollJoinRequest caller: negative = "no join pending";
            # the knocker's connection is parked unserviced forever.
            return s._replace(j_status="parked")
        acting_epoch = s.s_epoch if s.s_promoted else s.c_epoch
        prior = [t for t in s.tickets if t[2] == wire_id]
        if prior:
            if self.idempotent_reissue:
                epoch, rank, _ = prior[-1]  # re-issue the SAME seat
                if frames is not None:
                    frames.append(("JOIN_ACK", wire.JoinTicket(
                        epoch=epoch, new_size=4, assigned_rank=rank), 0))
                return s._replace(ack_link=s.ack_link + ((epoch, rank),))
            # BUG KNOB: the coordinator forgot it already seated this id
            # and hands the retry a SECOND seat in the same membership.
            epoch, rank = prior[-1][0], prior[-1][1] + 1
            return s._replace(tickets=s.tickets + ((epoch, rank, wire_id),),
                              ack_link=s.ack_link + ((epoch, rank),))
        epoch, rank = acting_epoch + 1, 3  # admit: grow 3 -> 4
        if frames is not None:
            frames.append(("JOIN_ACK", wire.JoinTicket(
                epoch=epoch, new_size=4, assigned_rank=rank), 0))
            frames.append(("RECONFIG", wire.ReconfigInfo(
                epoch=epoch, new_size=4, failed_rank=-1, cause="join",
                new_ranks=(0, 1, 2)), epoch))
        s = s._replace(tickets=s.tickets + ((epoch, rank, wire_id),),
                       ack_link=s.ack_link + ((epoch, rank),),
                       w_link=s.w_link + (("RECONFIG", epoch),))
        if s.s_promoted:
            return s._replace(s_epoch=epoch,
                              rep_joins=s.rep_joins + 1)
        # Epoch bumps replicate to the standby SYNCHRONOUSLY before the
        # verdict is externalized (only seq/LRU deltas stream async over
        # STATE): a promotion from a replica that lags the epoch would
        # mint an epoch the old coordinator already used — split-brain
        # with no fencing.  The checker derives that counterexample the
        # moment this barrier is removed.
        return s._replace(c_epoch=epoch, c_joins=s.c_joins + 1,
                          rep_epoch=epoch, rep_joins=s.rep_joins + 1)
