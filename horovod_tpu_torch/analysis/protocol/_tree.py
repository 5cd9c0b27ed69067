"""Coordinator-tree model — the relay-tier spec, checked before built.

Today's engine tears the tree down to a star on ANY reconfiguration
(elastic.reconfigure forces HVD_TPU_TREE_ENABLE=0) and cannot survive
root death in tree mode.  This model is the transition system for the
"one fabric" extension: a root (+ pre-bound root standby), G relay
groups (primary + standby each, AGG_STATE-replicated), and F members per
group running the lockstep tick through AGG_REQUEST/RESPONSE.  Faults:
one SIGKILL of a relay primary or of the root, at any event boundary.

The three ordering rules the checker PROVES are load-bearing (flip any
flag to False and the checker produces a wedged-trace counterexample;
all True and every interleaving drains):

* ``replicate_before_fanout`` — a relay sends AGG_STATE {seq, response}
  to its standby AFTER the root's response arrives and BEFORE fanning
  out to members (message.h AggState doc).  Otherwise a crash
  mid-fan-out strands the unreached members: the promoted standby has
  nothing to replay and the group can never re-aggregate (members split
  across two ticks).
* ``root_replicate_before_send`` — the root replicates the decided
  broadcast to its standby BEFORE the first per-relay send.  Otherwise
  a root crash mid-dispatch promotes a standby that never saw the
  verdict: the already-served groups run one tick ahead and the new
  root can serve neither seq.
* ``root_replays_stale`` — a (re-)sent AGG_REQUEST carrying an
  already-answered seq gets the last broadcast replayed, not dropped
  (message.h AggRequestList doc).  Promoted relay standbys re-ask for
  the tick their dead primary never fanned out.

Epoch bumps ride root promotion only (RECONFIG with the relay tier kept
alive — the incremental re-plan); relay promotion is group-local.  These
rules ARE the spec the native implementation of item 3 builds against.
"""

from __future__ import annotations

from typing import NamedTuple

from horovod_tpu_torch.analysis.protocol import wire
from horovod_tpu_torch.analysis.protocol.invariants import standby_not_ahead


class RelayS(NamedTuple):
    alive: bool          # primary up
    promoted: bool       # standby took over the group
    collected: tuple     # member local ids announced for the pending tick
    up_seq: int          # seq of the AGG_REQUEST sent up (valid if sent_up)
    sent_up: bool
    sent_epoch: int      # epoch the AGG_REQUEST was sent under
    resp_seq: int        # response held for fan-out (-1 = none)
    replicated: bool     # AGG_STATE for resp_seq reached the standby
    fanned: tuple        # member local ids already served resp_seq
    high_seq: int        # highest response the primary ever held
    standby_seq: int     # standby's replicated response seq (-1 = none)


class MS(NamedTuple):
    phase: str           # "run" | "wait"
    done: int            # ticks completed
    attached: str        # "primary" | "standby"


class TState(NamedTuple):
    epoch: int
    crash_budget: int
    r_alive: bool        # root primary
    r_promoted: bool     # root standby took over
    r_seq: int           # next seq the acting root negotiates
    r_last: int          # last decided seq (-1 = none yet)
    r_rep: int           # root standby's replicated last-broadcast seq
    r_got: tuple         # groups whose AGG_REQUEST for r_seq arrived
    r_dispatching: bool
    r_sent: tuple        # groups served r_last so far this dispatch
    relays: tuple        # RelayS per group
    members: tuple       # tuple-of-tuples MS [group][k]

    def replication_pairs(self):
        for g, r in enumerate(self.relays):
            if r.alive:
                yield (f"relay-{g}", r.high_seq, r.standby_seq)
        if self.r_alive:
            yield ("root", self.r_last, self.r_rep)


class TreeModel:
    """See module docstring; all-True flags = the verified relay-tier spec."""

    def __init__(self, groups: int = 2, fanout: int = 2, ticks: int = 2,
                 crashes: int = 1, replicate_before_fanout: bool = True,
                 root_replicate_before_send: bool = True,
                 root_replays_stale: bool = True) -> None:
        self.g = groups
        self.f = fanout
        self.t = ticks
        self.crashes = crashes
        self.replicate_before_fanout = replicate_before_fanout
        self.root_replicate_before_send = root_replicate_before_send
        self.root_replays_stale = root_replays_stale
        self.invariants = [
            ("standby-not-ahead", standby_not_ahead),
            ("response-continuity", self._continuity),
        ]

    def _continuity(self, s: TState) -> str | None:
        for g in range(self.g):
            for k in range(self.f):
                m = s.members[g][k]
                if m.done > self.t:
                    return f"member {g}.{k} served {m.done} > {self.t} ticks"
        return None

    def initial(self) -> TState:
        relay = RelayS(True, False, (), -1, False, 0, -1, False, (), -1, -1)
        return TState(0, self.crashes, True, False, 0, -1, -1, (), False,
                      (), (relay,) * self.g,
                      ((MS("run", 0, "primary"),) * self.f,) * self.g)

    # -- helpers ------------------------------------------------------------

    def _relay_up(self, r: RelayS) -> bool:
        return r.alive or r.promoted

    def _root_up(self, s: TState) -> bool:
        return s.r_alive or s.r_promoted

    def _attached_up(self, s: TState, g: int, m: MS) -> bool:
        r = s.relays[g]
        return r.alive if m.attached == "primary" else r.promoted

    def _agg_ready(self, s: TState, g: int) -> int | None:
        """The seq this group can aggregate now, or None."""
        r = s.relays[g]
        if not self._relay_up(r) or r.sent_up or r.resp_seq >= 0:
            return None
        eligible = [k for k in range(self.f)
                    if s.members[g][k].done < self.t]
        if not eligible or set(r.collected) != set(eligible):
            return None
        dones = {s.members[g][k].done for k in eligible}
        return dones.pop() if len(dones) == 1 else None

    # -- scheduler interface ------------------------------------------------

    def events(self, s: TState) -> list[tuple]:
        evs: list[tuple] = []
        for g in range(self.g):
            r = s.relays[g]
            for k in range(self.f):
                m = s.members[g][k]
                if m.phase == "run" and m.done < self.t and \
                        self._attached_up(s, g, m):
                    evs.append(("announce", g, k))
                if m.attached == "primary" and not r.alive and r.promoted:
                    evs.append(("member_failover", g, k))
                if r.promoted and m.attached == "standby" and \
                        m.phase == "wait" and m.done == r.standby_seq:
                    evs.append(("standby_replay", g, k))
                if r.resp_seq >= 0 and self._relay_up(r) and \
                        k not in r.fanned and m.phase == "wait" and \
                        m.done == r.resp_seq and \
                        self._attached_up(s, g, m) and \
                        (not self.replicate_before_fanout or not r.alive
                         or r.replicated):
                    evs.append(("relay_fanout", g, k))
            if self._agg_ready(s, g) is not None and self._root_up(s):
                evs.append(("agg_up", g))
            if r.sent_up and r.sent_epoch < s.epoch and self._root_up(s):
                evs.append(("resend_up", g))
            if r.alive and r.resp_seq >= 0 and not r.replicated:
                evs.append(("relay_replicate", g))
            if r.alive and not r.promoted and s.crash_budget > 0:
                evs.append(("crash_relay", g))
            if not r.alive and not r.promoted:
                evs.append(("promote_relay", g))
        if self._root_up(s):
            if not s.r_dispatching and len(set(s.r_got)) == self.g:
                evs.append(("root_decide",))
            if s.r_dispatching:
                for g in range(self.g):
                    if g not in s.r_sent and \
                            (not self.root_replicate_before_send
                             or not s.r_alive or s.r_rep >= s.r_last):
                        evs.append(("root_send", g))
        if s.r_alive and s.r_rep < s.r_last:
            evs.append(("root_replicate",))
        if s.r_alive and s.crash_budget > 0:
            evs.append(("crash_root",))
        if not s.r_alive and not s.r_promoted:
            evs.append(("promote_root",))
        return evs

    def apply(self, s: TState, ev: tuple) -> TState:
        return self._apply(s, ev, collect=False)[0]

    def wire_frames(self, s: TState, ev: tuple) -> list[tuple]:
        return self._apply(s, ev, collect=True)[1]

    def truncated(self, s: TState) -> bool:
        return False

    def is_optional(self, ev: tuple) -> bool:
        # The SIGKILL monkey may never strike; a wedge with crash budget
        # left over is still a wedge.
        return ev[0] in ("crash_relay", "crash_root")

    def quiescent_violation(self, s: TState) -> str | None:
        for g in range(self.g):
            for k in range(self.f):
                m = s.members[g][k]
                if m.done < self.t:
                    return (f"member {g}.{k} wedged at tick {m.done}/"
                            f"{self.t} (phase {m.phase}, attached "
                            f"{m.attached}) — trace ends hung")
        return None

    # -- transitions --------------------------------------------------------

    def _apply(self, s: TState, ev: tuple, collect: bool):
        frames: list[tuple] = []
        kind = ev[0]
        if kind == "announce":
            g, k = ev[1], ev[2]
            r = s.relays[g]
            if collect:
                frames.append(("REQUEST", wire.RequestList(requests=(
                    wire.Request(rank=self._rank(g, k), name="grad:0",
                                 dims=(4,)),)), s.epoch))
            s = self._set_member(s, g, k,
                                 s.members[g][k]._replace(phase="wait"))
            if k not in r.collected:
                s = self._set_relay(s, g, r._replace(
                    collected=r.collected + (k,)))
        elif kind == "member_failover":
            g, k = ev[1], ev[2]
            m = s.members[g][k]._replace(attached="standby")
            s = self._set_member(s, g, k, m)
            r = s.relays[g]
            if m.phase == "wait" and k not in r.collected:
                # re-announce the awaited tick to the promoted standby
                s = self._set_relay(s, g, r._replace(
                    collected=r.collected + (k,)))
        elif kind == "standby_replay":
            g, k = ev[1], ev[2]
            m = s.members[g][k]
            if collect:
                frames.append(self._response_frame(s, m.done))
            s = self._set_member(s, g, k, m._replace(phase="run",
                                                     done=m.done + 1))
            r = s.relays[g]
            s = self._set_relay(s, g, r._replace(
                collected=tuple(c for c in r.collected if c != k)))
            s = self._gc_stale_resp(s, g)
        elif kind == "relay_fanout":
            g, k = ev[1], ev[2]
            s = self._fanout(s, g, k, frames if collect else None)
        elif kind == "agg_up" or kind == "resend_up":
            s = self._send_up(s, ev[1], kind == "resend_up",
                              frames if collect else None)
        elif kind == "relay_replicate":
            r = s.relays[ev[1]]
            if collect:
                frames.append(("AGG_STATE", wire.AggState(
                    seq=r.resp_seq,
                    response=wire.ResponseList().encode()), s.epoch))
            s = self._set_relay(s, ev[1], r._replace(
                standby_seq=r.resp_seq, replicated=True))
        elif kind == "crash_relay":
            s = self._set_relay(s, ev[1],
                                s.relays[ev[1]]._replace(alive=False))
            s = s._replace(crash_budget=s.crash_budget - 1)
        elif kind == "promote_relay":
            g = ev[1]
            r = s.relays[g]
            # the standby starts from its replica: no announces, nothing
            # in flight up, and only standby_seq's response to replay
            s = self._set_relay(s, g, r._replace(
                promoted=True, collected=(), sent_up=False, resp_seq=-1,
                fanned=()))
        elif kind == "root_decide":
            s = s._replace(r_last=s.r_seq, r_seq=s.r_seq + 1,
                           r_dispatching=True, r_sent=(), r_got=())
        elif kind == "root_send":
            s = self._root_send(s, ev[1], frames if collect else None)
        elif kind == "root_replicate":
            if collect:
                frames.append(("STATE", wire.CoordState(
                    epoch=s.epoch, verify_tick=s.r_last), s.epoch))
            s = s._replace(r_rep=s.r_last)
        elif kind == "crash_root":
            s = s._replace(r_alive=False,
                           crash_budget=s.crash_budget - 1)
        elif kind == "promote_root":
            # Incremental re-plan: epoch bumps, RECONFIG keeps every
            # unaffected relay alive; the promoted root resumes from its
            # replica (r_rep answered, r_rep + 1 next).
            epoch = s.epoch + 1
            if collect:
                frames.append(("RECONFIG", wire.ReconfigInfo(
                    epoch=epoch, new_size=1 + self.g * self.f,
                    failed_rank=0, cause="heartbeat_timeout",
                    new_coord_rank=1 + self.g * self.f), epoch))
            s = s._replace(r_promoted=True, epoch=epoch,
                           r_seq=s.r_rep + 1, r_last=s.r_rep, r_got=(),
                           r_dispatching=False, r_sent=())
        else:
            raise ValueError(f"unknown event {ev}")
        return s, frames

    def _rank(self, g: int, k: int) -> int:
        return 1 + g * self.f + k

    def _response_frame(self, s: TState, seq: int) -> tuple:
        return ("RESPONSE", wire.ResponseList(responses=(
            wire.Response(type=wire.RESP_ALLREDUCE,
                          tensor_names=("grad:0",)),)), s.epoch)

    def _fanout(self, s: TState, g: int, k: int, frames) -> TState:
        r = s.relays[g]
        m = s.members[g][k]
        if frames is not None:
            frames.append(self._response_frame(s, r.resp_seq))
        s = self._set_member(s, g, k, m._replace(phase="run",
                                                 done=m.done + 1))
        s = self._set_relay(s, g, r._replace(
            fanned=r.fanned + (k,),
            collected=tuple(c for c in r.collected if c != k)))
        return self._gc_stale_resp(s, g)

    def _gc_stale_resp(self, s: TState, g: int) -> TState:
        """A relay discards its held broadcast once every member has
        advanced past it — whether they were served by fan-out or by the
        promoted standby's replica replay.  Without this GC a response
        that raced a replay wedges the group: _agg_ready stays blocked on
        resp_seq >= 0 and no fan-out event can ever fire to clear it."""
        r = s.relays[g]
        if r.resp_seq >= 0 and all(s.members[g][j].done > r.resp_seq
                                   for j in range(self.f)):
            r = r._replace(resp_seq=-1, fanned=(), replicated=False)
            return self._set_relay(s, g, r)
        return s

    def _send_up(self, s: TState, g: int, resend: bool, frames) -> TState:
        r = s.relays[g]
        seq = r.up_seq if resend else self._agg_ready(s, g)
        if frames is not None:
            members = tuple(self._rank(g, k) for k in range(self.f))
            frames.append(("AGG_REQUEST", wire.AggRequestList(
                agg_id=g, seq=seq, members=members,
                residual=(wire.RequestList(),) * self.f), s.epoch))
        r = r._replace(sent_up=True, up_seq=seq, sent_epoch=s.epoch)
        s = self._set_relay(s, g, r)
        if seq == s.r_seq:
            if g not in s.r_got:
                s = s._replace(r_got=s.r_got + (g,))
        elif seq == s.r_last and self.root_replays_stale:
            # replay the last broadcast to this (probably just-promoted)
            # relay — the root keeps exactly one answered seq around
            s = self._serve_relay(s, g, seq, frames)
        # else: already-answered-but-unreplayable or future seq — dropped;
        # the quiescence check will surface the wedge if it matters
        return s

    def _serve_relay(self, s: TState, g: int, seq: int, frames) -> TState:
        r = s.relays[g]
        if frames is not None:
            frames.append(self._response_frame(s, seq))
        if not self._relay_up(r):
            return s  # sent to a dead relay: lost on the wire
        if all(s.members[g][j].done > seq for j in range(self.f)):
            # Duplicate broadcast (a replay raced the root's dispatch of
            # the same seq): every member is already past it — discard,
            # or it would clobber the in-progress next aggregation.
            return s
        return self._set_relay(s, g, r._replace(
            resp_seq=seq, replicated=False, fanned=(), sent_up=False,
            high_seq=max(r.high_seq, seq) if r.alive else r.high_seq))

    def _root_send(self, s: TState, g: int, frames) -> TState:
        s = self._serve_relay(s, g, s.r_last, frames)
        sent = s.r_sent + (g,)
        if set(sent) >= set(range(self.g)):
            return s._replace(r_sent=(), r_dispatching=False)
        return s._replace(r_sent=sent)

    def _set_relay(self, s: TState, g: int, r: RelayS) -> TState:
        return s._replace(relays=s.relays[:g] + (r,) + s.relays[g + 1:])

    def _set_member(self, s: TState, g: int, k: int, m: MS) -> TState:
        grp = s.members[g][:k] + (m,) + s.members[g][k + 1:]
        return s._replace(members=s.members[:g] + (grp,)
                          + s.members[g + 1:])
