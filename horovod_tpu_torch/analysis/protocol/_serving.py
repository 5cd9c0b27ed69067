"""Star + elastic + serving-drain composition model.

One coordinator (co-located with replica 0, like a serving fleet's rank 0)
and N serving replicas running the worker loop of serving/worker.py:
complete requests, tick the fixed ``serving.tick`` collective every cycle,
drain on QUIT via the one-shot ``serving.drained`` collective.  Links are
per-direction FIFO queues (TCP ordering); frames carry the membership
epoch and both sides drop stale-epoch frames, mirroring the FrameHeader
flags protocol.

Two constructor flags select the PRE-FIX behavior so the checker
can re-derive both shipped bugs as counterexamples:

* ``deliver_before_tick=False`` — completions are parked until the tick's
  RESPONSE arrives (the pre-fix ServingEngine.step order); a RECONFIG
  that aborts the in-flight tick destroys the engine holding them ->
  "no accepted completion lost" violation.  The fix (serving/engine.py)
  delivers via on_complete BEFORE announcing the tick.
* ``drain_by_protocol=False`` — a quitting replica exits the loop as soon
  as its OWN queue drains (pre-fix worker.py); a peer mid-tick then waits
  forever for the exited replica's announce -> quiescence violation (the
  QUIT drain wedge).  The fix keeps ticking with done_flag raised and
  leaves only when the fleet-wide ``serving.drained`` one-shot completes.

A third flag covers the prefix-cache refcount protocol
(serving/prefix_cache.py): every pending request on a replica holds a
reference on that replica's shared prefix KV page, and the page may be
freed only when the last reference drops.

* ``refcount_shared_pages=False`` — the page is freed on the FIRST slot
  release regardless of the other live references (and torn down on a
  RECONFIG while slots still point at it) -> "page-refcount" violation:
  a surviving slot now decodes through a recycled page.  The fix
  (PrefixCache.release) decrements and frees only at refs == 0; refcounts
  survive RECONFIG because the engine re-admits slots before releasing.

All flags True models the code as shipped today; the bounded exhaustive
run over that configuration passing all invariants is the model-check
leg of the pre-PR gate.
"""

from __future__ import annotations

from typing import NamedTuple

from horovod_tpu_torch.analysis.protocol import wire
from horovod_tpu_torch.analysis.protocol.invariants import (
    epoch_not_ahead, no_lost_completion, shared_page_refcounted)


class WState(NamedTuple):
    status: str          # "up" | "crashed" | "exited"
    phase: str           # "run" | "wait" (REQUEST announced, awaiting
                         # RESPONSE — inside the blocking collective)
    epoch: int
    pending: int         # accepted requests not yet completed
    done_pending: int    # completed but delivery deferred past the tick
    delivered: int
    lost: int            # completions destroyed with a replaced engine
    quitting: bool
    drain_enqueued: bool  # the one-shot serving.drained is pending
    page_refs: int       # live slot references on the shared prefix page
    page_live: bool      # the shared KV page is still allocated


class FleetState(NamedTuple):
    epoch: int
    members: tuple       # coordinator's live-membership view
    announced: tuple     # ids announced for the current tick
    drain_announced: tuple
    crash_budget: int
    detect_pending: tuple
    workers: tuple       # WState per replica id
    up_links: tuple      # per id: FIFO of frames replica -> coordinator
    down_links: tuple    # per id: FIFO of frames coordinator -> replica


def _tick_request(epoch: int, drain: bool) -> tuple:
    """The real RequestList a serving replica's cycle announces."""
    reqs = [wire.Request(rank=0, op=wire.OP_ALLREDUCE, dtype=wire.DT_FLOAT32,
                         name="serving.tick", dims=(10,))]
    if drain:
        reqs.append(wire.Request(rank=0, op=wire.OP_ALLREDUCE,
                                 dtype=wire.DT_FLOAT32,
                                 name="serving.drained", dims=(1,)))
    return ("REQUEST", wire.RequestList(requests=tuple(reqs)), epoch)


class ServingDrainModel:
    """See module docstring.  Flags (False, False) = pre-fix."""

    def __init__(self, workers: int = 2, reqs: int = 1, crashes: int = 1,
                 deliver_before_tick: bool = True,
                 drain_by_protocol: bool = True,
                 refcount_shared_pages: bool = True) -> None:
        self.n = workers
        self.reqs = reqs
        self.crashes = crashes
        self.deliver_before_tick = deliver_before_tick
        self.drain_by_protocol = drain_by_protocol
        self.refcount_shared_pages = refcount_shared_pages
        self.invariants = [
            ("no-lost-completion", no_lost_completion),
            ("epoch-monotonic", epoch_not_ahead),
            ("page-refcount", shared_page_refcounted),
        ]

    def initial(self) -> FleetState:
        # Every accepted request holds a reference on the replica's shared
        # prefix page (the PrefixCache admission contract).
        w = WState("up", "run", 0, self.reqs, 0, 0, 0, False, False,
                   self.reqs, True)
        return FleetState(epoch=0, members=tuple(range(self.n)),
                          announced=(), drain_announced=(),
                          crash_budget=self.crashes, detect_pending=(),
                          workers=(w,) * self.n,
                          up_links=((),) * self.n, down_links=((),) * self.n)

    # -- scheduler interface ------------------------------------------------

    def events(self, s: FleetState) -> list[tuple]:
        evs: list[tuple] = []
        for i, w in enumerate(s.workers):
            if w.status == "up" and w.phase == "run":
                evs.append(("step", i))
        for i in range(self.n):
            if s.up_links[i]:
                evs.append(("deliver_req", i))
            if s.down_links[i] and s.workers[i].status == "up":
                evs.append(("deliver_resp", i))
        for i, w in enumerate(s.workers):
            if w.status == "up" and not w.quitting:
                evs.append(("quit", i))
        if s.crash_budget > 0:
            for i in range(1, self.n):
                if s.workers[i].status == "up":
                    evs.append(("crash", i))
        for i in s.detect_pending:
            evs.append(("detect", i))
        return evs

    def apply(self, s: FleetState, ev: tuple) -> FleetState:
        return self._apply(s, ev, collect=False)[0]

    def wire_frames(self, s: FleetState, ev: tuple) -> list[tuple]:
        """(frame_name, payload_struct, epoch) sent while processing ev."""
        return self._apply(s, ev, collect=True)[1]

    def truncated(self, s: FleetState) -> bool:
        return False  # the model is finite: no horizon cutoffs

    def is_optional(self, ev: tuple) -> bool:
        # Environment choices: the client may never QUIT, the chaos monkey
        # may never strike.  Quiescence is judged with these set aside.
        return ev[0] in ("quit", "crash")

    def quiescent_violation(self, s: FleetState) -> str | None:
        for i, w in enumerate(s.workers):
            if w.status == "up":
                return (f"replica {i} wedged: status=up phase={w.phase} "
                        f"quitting={w.quitting} — trace ends hung, not "
                        f"drained or aborted")
        return None

    # -- transition function ------------------------------------------------

    def _apply(self, s: FleetState, ev: tuple, collect: bool):
        frames: list[tuple] = []
        kind = ev[0]
        if kind == "step":
            s = self._step(s, ev[1], frames if collect else None)
        elif kind == "deliver_req":
            s = self._deliver_req(s, ev[1], frames if collect else None)
        elif kind == "deliver_resp":
            s = self._deliver_resp(s, ev[1])
        elif kind == "quit":
            s = self._patch_worker(s, ev[1], quitting=True)
        elif kind == "crash":
            i = ev[1]
            s = self._patch_worker(s, i, status="crashed")
            s = s._replace(
                crash_budget=s.crash_budget - 1,
                detect_pending=s.detect_pending + (i,),
                up_links=_tset(s.up_links, i, ()),
                down_links=_tset(s.down_links, i, ()))
        elif kind == "detect":
            s = self._detect(s, ev[1], frames if collect else None)
        else:
            raise ValueError(f"unknown event {ev}")
        return s, frames

    def _step(self, s: FleetState, i: int, frames) -> FleetState:
        w = s.workers[i]
        completed = 1 if w.pending > 0 else 0
        pending = w.pending - completed
        done_pending, delivered = w.done_pending, w.delivered
        page_refs, page_live = w.page_refs, w.page_live
        if completed:
            page_refs -= completed
            if self.refcount_shared_pages:
                # Fixed order (PrefixCache.release): deref, free only when
                # the LAST reference drops.
                page_live = page_live and page_refs > 0
            else:
                # PRE-FIX: the first slot release frees the shared page
                # outright, ignoring the other live references.
                page_live = False
        if self.deliver_before_tick:
            # Fixed order (serving/engine.py): on_complete fires before the
            # tick collective, so nothing rides across MembershipChanged.
            delivered += completed + done_pending
            done_pending = 0
        else:
            done_pending += completed
        mine_done = w.quitting and pending == 0
        if not self.drain_by_protocol and mine_done:
            # Pre-fix worker.py: leave as soon as MY queue drains, peers
            # mid-tick be damned.
            w = w._replace(status="exited", pending=pending,
                           done_pending=done_pending, delivered=delivered,
                           page_refs=page_refs, page_live=page_live)
            return _tset_worker(s, i, w)
        drain_enq = w.drain_enqueued or (mine_done and self.drain_by_protocol)
        if frames is not None:
            frames.append(_tick_request(w.epoch, drain_enq))
        w = w._replace(phase="wait", pending=pending,
                       done_pending=done_pending, delivered=delivered,
                       drain_enqueued=drain_enq,
                       page_refs=page_refs, page_live=page_live)
        s = _tset_worker(s, i, w)
        return s._replace(
            up_links=_tset(s.up_links, i,
                           s.up_links[i] + (("REQ", w.epoch, int(drain_enq)),
                                            )))

    def _deliver_req(self, s: FleetState, i: int, frames) -> FleetState:
        frame, rest = s.up_links[i][0], s.up_links[i][1:]
        s = s._replace(up_links=_tset(s.up_links, i, rest))
        _, epoch, drain = frame
        if epoch != s.epoch or i not in s.members:
            return s  # stale_epoch: straggler from a pre-shrink membership
        announced = s.announced if i in s.announced else s.announced + (i,)
        drained = s.drain_announced
        if drain and i not in drained:
            drained = drained + (i,)
        s = s._replace(announced=announced, drain_announced=drained)
        return self._maybe_dispatch(s, frames)

    def _maybe_dispatch(self, s: FleetState, frames) -> FleetState:
        if not s.members or not set(s.announced) >= set(s.members):
            return s
        drained = set(s.drain_announced) >= set(s.members)
        down = list(s.down_links)
        for m in s.members:
            if s.workers[m].status == "up":
                down[m] = down[m] + (("RESP", s.epoch, int(drained)),)
        if frames is not None:
            names = ("serving.tick", "serving.drained") if drained \
                else ("serving.tick",)
            frames.append(("RESPONSE", wire.ResponseList(responses=(
                wire.Response(type=wire.RESP_ALLREDUCE,
                              tensor_names=names),)), s.epoch))
        return s._replace(announced=(), down_links=tuple(down))

    def _deliver_resp(self, s: FleetState, i: int) -> FleetState:
        frame, rest = s.down_links[i][0], s.down_links[i][1:]
        s = s._replace(down_links=_tset(s.down_links, i, rest))
        w = s.workers[i]
        if frame[0] == "RESP":
            _, epoch, drained = frame
            if epoch != w.epoch or w.phase != "wait":
                return s  # stale response from a replaced membership
            delivered, done_pending = w.delivered, w.done_pending
            if not self.deliver_before_tick:
                delivered += done_pending
                done_pending = 0
            w = w._replace(phase="run", delivered=delivered,
                           done_pending=done_pending)
            if drained and w.drain_enqueued:
                w = w._replace(status="exited")
            return _tset_worker(s, i, w)
        # RECONFIG: MembershipChanged — the engine is replaced wholesale.
        _, epoch, members = frame
        if i not in members:
            return _tset_worker(s, i, w._replace(status="exited"))
        lost, done_pending = w.lost, w.done_pending
        if w.phase == "wait" and not self.deliver_before_tick:
            # THE BUG: completions parked for post-tick delivery die
            # with the aborted collective's engine.
            lost += done_pending
            done_pending = 0
        page_live = w.page_live
        if not self.refcount_shared_pages and w.page_refs > 0:
            # PRE-FIX page bug, RECONFIG flavor: the replaced engine tears
            # its KV pool down wholesale while re-admitted slots still
            # point at the shared page.  The fix keeps refcounts across
            # RECONFIG: slots survive, so their references do too.
            page_live = False
        w = w._replace(phase="run", epoch=epoch, lost=lost,
                       done_pending=done_pending, drain_enqueued=False,
                       page_live=page_live)
        return _tset_worker(s, i, w)

    def _detect(self, s: FleetState, i: int, frames) -> FleetState:
        members = tuple(m for m in s.members if m != i)
        epoch = s.epoch + 1
        down = list(s.down_links)
        for m in members:
            if s.workers[m].status == "up":
                down[m] = down[m] + (("RECONFIG", epoch, members),)
        if frames is not None:
            new_ranks = tuple(-1 if r == i else members.index(r)
                              if r in members else -1
                              for r in range(self.n))
            frames.append(("RECONFIG", wire.ReconfigInfo(
                epoch=epoch, new_size=len(members), failed_rank=i,
                cause="connection_reset", new_ranks=new_ranks), epoch))
        return s._replace(
            epoch=epoch, members=members, announced=(), drain_announced=(),
            detect_pending=tuple(d for d in s.detect_pending if d != i),
            down_links=tuple(down))

    def _patch_worker(self, s: FleetState, i: int, **kw) -> FleetState:
        return _tset_worker(s, i, s.workers[i]._replace(**kw))


def _tset(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _tset_worker(s: FleetState, i: int, w: WState) -> FleetState:
    return s._replace(workers=_tset(s.workers, i, w))
