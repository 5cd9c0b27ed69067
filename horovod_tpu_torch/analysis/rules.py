"""hvd-lint rule catalog for the PyTorch port — AST checks for the
collective contract.

Every rule encodes one way real jobs deadlock or silently diverge at scale:
collectives are only correct when every rank issues the same collectives in
the same program order.  The stall detector (core/src/controller.cc)
reports these failures at runtime after the fact; these rules reject them
before launch.

The catalog keeps the JAX package's ten codes.  Six rules carry over with
the port's names (HVD101, 102, 103, 106, 107, 110); in the port the
in-process collectives are plain ``torch.distributed`` calls (or the
group collectives of ``parallel/common.py``) rather than ``lax`` calls
inside a traced function, so :data:`COLLECTIVE_CALLS` and
:data:`RANK_CALLS` also know their spellings.  Four rules were
JAX-specific and have torch-side counterparts under the same code
(HVD104, 105, 108, 109); each docstring states the hazard it flags.

Rules are pluggable: subclass :class:`Rule`, set ``code``/``name``/``hint``,
implement ``run``, and append to :data:`RULES`.  Each finding carries the
rule's error code (suppress with ``# hvd-lint: disable=CODE`` on the
flagged line) and a fix-it hint.  Pure stdlib (ast only) — linting a tree
never imports torch.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    code: str
    line: int
    col: int
    message: str
    hint: str


_DIST = "torch.distributed."
_COMMON = "horovod_tpu_torch.parallel.common."

# Public collective entry points, by terminal name (ops/collective_ops.py,
# ops/async_ops.py, torch/state.py object and parameter helpers), and the
# in-process collectives by their full path once imports are resolved
# (``dist.all_reduce`` -> ``torch.distributed.all_reduce``).  All of these
# must be issued in identical program order on every rank.  Point-to-point
# sends and receives are not collectives: a rank-conditional send/recv
# pair is the normal idiom.
COLLECTIVE_CALLS = frozenset({
    "allreduce", "allgather", "broadcast", "alltoall",
    "grouped_allreduce", "quantized_grouped_allreduce", "allreduce_sparse",
    "allreduce_async", "allgather_async", "broadcast_async",
    "alltoall_async", "barrier",
    "allgather_object", "broadcast_object", "broadcast_parameters",
    "broadcast_optimizer_state",
}) | frozenset(_DIST + n for n in (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather",
    "gather_object", "scatter", "scatter_object_list", "barrier",
    "monitored_barrier",
)) | frozenset(_COMMON + n for n in (
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
    "reduce_forward", "reduce_backward", "differentiable_all_to_all",
))

# The subset that routes through the native engine's name table, where a
# reused auto-name aborts with the duplicate-tensor-name error
# (core/engine.py enqueue) and cross-rank name sequences must agree.
ENGINE_COLLECTIVES = frozenset({
    "allreduce_async", "allgather_async", "broadcast_async",
    "alltoall_async", "barrier",
})

# Process-identity calls (basics.py): the terminal names count only with
# zero arguments, which keeps tensor-rank helpers like ``tf.rank(x)`` out;
# the resolved paths count with any arguments (a rank within a group).
RANK_CALLS = frozenset({"rank", "local_rank", "cross_rank"}) | frozenset({
    _DIST + "get_rank", _DIST + "get_node_local_rank",
    _COMMON + "group_rank",
})

# ``torch.distributed`` calls that create a process group.  Every process
# of the job must make each of them, with the same ranks, in the same
# order, members or not (HVD105).
GROUP_CALLS = frozenset({"new_group", "new_subgroups",
                         "new_subgroups_by_enumeration"})


def call_name(node: ast.Call) -> str | None:
    """Terminal name of a call: ``hvd.ops.allreduce(...)`` -> ``allreduce``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def dotted(node: ast.AST) -> str | None:
    """Full dotted path of a Name/Attribute chain, or None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def kwarg(node: ast.Call, name: str) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


class Context:
    """Per-module facts shared by rules (import table, etc.)."""

    def __init__(self, module: ast.Module):
        self.module = module
        # local alias -> imported dotted module/symbol path
        self.imports: dict[str, str] = {}
        for node in ast.walk(module):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def resolve(self, path: str) -> str:
        """Rewrite the root of a dotted path through the import table:
        ``np.random.uniform`` -> ``numpy.random.uniform``."""
        root, _, rest = path.partition(".")
        base = self.imports.get(root, root)
        return f"{base}.{rest}" if rest else base

    def resolved(self, node: ast.Call) -> str | None:
        """The call's callee path, resolved through the import table."""
        path = dotted(node.func)
        return None if path is None else self.resolve(path)

    def is_collective(self, node: ast.AST,
                      names: frozenset[str] = COLLECTIVE_CALLS) -> bool:
        """``node`` is a call whose terminal name or resolved path is in
        ``names``."""
        if not isinstance(node, ast.Call):
            return False
        return call_name(node) in names or self.resolved(node) in names

    def is_rank_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        resolved = self.resolved(node) or ""
        if "." in resolved and resolved in RANK_CALLS:
            return True
        return (call_name(node) in RANK_CALLS and not node.args
                and not node.keywords)

    def rank_dependent(self, test: ast.expr) -> bool:
        return any(self.is_rank_call(n) for n in ast.walk(test))

    def collective_calls(self, tree: ast.AST) -> list[ast.Call]:
        return [n for n in ast.walk(tree) if self.is_collective(n)]


def rank_branches(tree: ast.AST, ctx: Context):
    """Every ``if``/conditional expression whose test depends on the rank:
    ``(node, body, orelse)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.If):
            body, orelse = node.body, node.orelse
        elif isinstance(node, ast.IfExp):
            body, orelse = [node.body], [node.orelse]
        else:
            continue
        if ctx.rank_dependent(node.test):
            yield node, body, orelse


def unordered_iter(it: ast.expr) -> bool:
    """``it`` iterates a set or a dict: an order that differs across
    processes (hash randomization) or follows rank-dependent insertion."""
    if isinstance(it, (ast.Set, ast.SetComp, ast.Dict, ast.DictComp)):
        return True
    if isinstance(it, ast.Call):
        return call_name(it) in {"set", "frozenset", "keys", "values",
                                 "items", "vars", "globals", "locals"}
    return False


class Rule:
    code = "HVD000"
    name = "abstract"
    hint = ""

    def run(self, ctx: Context) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, node: ast.AST, message: str) -> Finding:
        return Finding(self.code, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message, self.hint)


class RankDivergentCollective(Rule):
    """Collective reachable only under rank-dependent control flow.

    ``if hvd.rank() == 0: hvd.allreduce(x)`` deadlocks: the other ranks
    never issue the matching call, so rank 0 waits forever (the stall
    detector's #1 customer).  The same holds for ``dist.all_reduce`` under
    ``dist.get_rank() == 0``.  Branches are compared as multisets of
    collective call names — a broadcast in both arms is fine.
    """

    code = "HVD101"
    name = "rank-divergent-collective"
    hint = ("issue the same collective on every rank (hoist it out of the "
            "rank() branch, or mirror it on the other branch)")

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        for _node, body, orelse in rank_branches(ctx.module, ctx):
            body_calls = [c for stmt in body
                          for c in ctx.collective_calls(stmt)]
            else_calls = [c for stmt in orelse
                          for c in ctx.collective_calls(stmt)]
            bn = sorted(call_name(c) or "" for c in body_calls)
            en = sorted(call_name(c) or "" for c in else_calls)
            if bn == en:
                continue
            # Report at the collective(s) present on one side only.
            lonely = body_calls if len(bn) >= len(en) else else_calls
            c = lonely[0]
            other = "the other branch" if orelse else "the implicit else"
            out.append(self.finding(c, (
                f"collective '{call_name(c)}' is only reached when the "
                f"rank()-dependent condition holds; {other} issues "
                f"{en if len(bn) >= len(en) else bn or 'no collectives'} — "
                f"the ranks that take it will never match this call "
                f"(cross-rank deadlock)")))
        return out


class UnnamedCollectiveInLoop(Rule):
    """Engine-path collective inside a loop without an explicit ``name=``.

    Auto-names come from a per-process counter (ops/async_ops.py
    ``_auto_name``); any rank that issues one extra or one fewer op shifts
    every later auto-name, so the coordinator matches unrelated tensors or
    aborts with the duplicate-tensor-name error (core/engine.py).  Loops
    are where the counts drift (data-dependent trip counts).
    """

    code = "HVD102"
    name = "unnamed-collective-in-loop"
    hint = ("pass an explicit name= derived from stable loop state, e.g. "
            "name=f\"grad.{step}.{param}\"")

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []

        def visit(node: ast.AST, in_loop: bool) -> None:
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                for child in ast.iter_child_nodes(node):
                    visit(child, True)
                return
            if (isinstance(node, ast.Call)
                    and call_name(node) in ENGINE_COLLECTIVES and in_loop):
                name_kw = kwarg(node, "name")
                if name_kw is None or (isinstance(name_kw, ast.Constant)
                                       and name_kw.value is None):
                    out.append(self.finding(node, (
                        f"'{call_name(node)}' inside a loop without an "
                        f"explicit name=: auto-generated names come from a "
                        f"per-process counter and abort with the engine's "
                        f"duplicate-tensor-name error (or silently pair "
                        f"unrelated tensors) once rank op counts drift")))
            for child in ast.iter_child_nodes(node):
                visit(child, in_loop)

        visit(ctx.module, False)
        return out


class NondeterministicName(Rule):
    """Collective ``name=`` derived from ``id()`` or set/dict iteration.

    ``id()`` differs per process; set iteration order differs per process
    (hash randomization), and dict order reflects insertion order, which
    rank-dependent code paths easily perturb.  Either way two ranks
    announce different name sequences and the job deadlocks or pairs the
    wrong tensors.  ``sorted(...)`` over the same container is fine.
    """

    code = "HVD103"
    name = "nondeterministic-collective-name"
    hint = ("derive names from deterministic, rank-invariant data: "
            "sorted(container) instead of raw set/dict iteration, a "
            "parameter name instead of id()")

    @staticmethod
    def _tainted_names(scope: ast.AST) -> set[str]:
        tainted: set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, (ast.For, ast.AsyncFor)) and \
                    unordered_iter(node.iter):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for comp in node.generators:
                    if unordered_iter(comp.iter):
                        for t in ast.walk(comp.target):
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
        return tainted

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        tainted = self._tainted_names(ctx.module)
        for node in ast.walk(ctx.module):
            if not ctx.is_collective(node):
                continue
            name_kw = kwarg(node, "name")
            if name_kw is None:
                continue
            for sub in ast.walk(name_kw):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "id"):
                    out.append(self.finding(node, (
                        f"'{call_name(node)}' name derives from id(): "
                        f"object addresses differ across processes, so "
                        f"ranks announce different tensor names")))
                    break
                if isinstance(sub, ast.Name) and sub.id in tainted:
                    out.append(self.finding(node, (
                        f"'{call_name(node)}' name derives from "
                        f"'{sub.id}', bound by iterating an unordered "
                        f"set/dict: iteration order differs across "
                        f"processes, so ranks announce names in different "
                        f"orders")))
                    break
        return out


class ImpureCapturedStep(Rule):
    """Host randomness or clock read inside a traced or graph-captured step.

    ``random``/``numpy.random``/``time``/``datetime.now`` inside a function
    whose capture freezes Python-side values.  A captured program is recorded once and replayed: a Python value
    computed while it is recorded becomes a constant of the recording,
    frozen at capture time and frozen *differently* on every process
    (silent divergence of ranks that should run in lockstep).  What
    freezes depends on the capture form:

    * ``torch.jit.trace(fn, ...)`` records tensor operations only: every
      one of these values is frozen;
    * ``torch.cuda.make_graphed_callables(fn, ...)`` and the body of a
      ``with torch.cuda.graph(g):`` block replay CUDA kernels: every
      Python-side value is frozen at capture;
    * ``torch.compile`` is NOT flagged: dynamo draws ``random.random()``
      and ``numpy.random`` afresh on every call and breaks the graph at
      ``time.time()`` and ``datetime.now()``, so each call reads the
      clock (tests/test_torch_lint.py pins this);
    * ``torch.jit.script`` refuses these calls at compile time, so it
      needs no rule.

    Draw randomness from torch generators seeded identically on every
    rank (or broadcast the seed), and pass timestamps in as arguments.
    """

    code = "HVD104"
    name = "impure-captured-step"
    hint = ("inside a traced or CUDA-graph-captured function draw from a "
            "seeded torch.Generator (same seed on every rank) and pass "
            "wall-clock values in as arguments")

    # Resolved callee suffixes whose first argument is the captured callable.
    _CAPTURE_FNS = ("jit.trace", "make_graphed_callables")

    @staticmethod
    def _impure(ctx: Context, node: ast.Call) -> str | None:
        resolved = ctx.resolved(node)
        if resolved is None:
            return None
        if resolved.startswith("numpy.random.") or resolved == "numpy.random":
            return resolved
        if resolved == "random" or resolved.startswith("random."):
            return resolved
        if resolved == "time" or resolved.startswith("time."):
            return resolved
        if resolved.startswith("datetime.") and resolved.endswith(".now"):
            return resolved
        return None

    def _captured(self, ctx: Context):
        """(label, statements or expression) of every captured body."""
        defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(ctx.module):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        for node in ast.walk(ctx.module):
            if isinstance(node, ast.Call):
                resolved = ctx.resolved(node) or ""
                if not resolved.endswith(self._CAPTURE_FNS):
                    continue
                form = resolved.rsplit(".", 1)[-1]
                target = node.args[0] if node.args else (
                    kwarg(node, "func") or kwarg(node, "callables"))
                items = target.elts if isinstance(
                    target, (ast.Tuple, ast.List)) else [target]
                for item in items:
                    if isinstance(item, ast.Lambda):
                        yield form, "<lambda>", item.body
                    elif isinstance(item, (ast.Name, ast.Attribute)):
                        name = item.id if isinstance(item, ast.Name) \
                            else item.attr
                        for fn in defs.get(name, ()):
                            yield form, name, fn
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for w in node.items:
                    expr = w.context_expr
                    if isinstance(expr, ast.Call) and \
                            (ctx.resolved(expr) or "").endswith("cuda.graph"):
                        for stmt in node.body:
                            yield "cuda.graph", "with-block", stmt

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple[int, int]] = set()
        for form, label, body in self._captured(ctx):
            for sub in ast.walk(body):
                if not isinstance(sub, ast.Call):
                    continue
                resolved = self._impure(ctx, sub)
                key = (sub.lineno, sub.col_offset)
                if resolved is None or key in seen:
                    continue
                seen.add(key)
                out.append(self.finding(sub, (
                    f"'{resolved}' called inside '{label}', captured by "
                    f"{form}: the value is frozen at capture time, "
                    f"differently on every process (silent divergence)")))
        return out


class DivergentGroupCreation(Rule):
    """Process group created on some processes only, or in varying order.

    The port has no mesh axes, only process groups, and PyTorch's contract
    for ``new_group`` (and ``new_subgroups``) is that every process of the
    job calls it, with the same ranks, in the same order, members or not:
    groups are numbered by a per-process counter, so a process that skips
    one (or makes them in another order) pairs its later groups with the
    wrong ones of its peers, and their first collective hangs.  Two ways
    to break it are flagged:

    * a group created under a rank-dependent condition (``if rank in
      members: g = dist.new_group(members)``) whose branches do not create
      the same groups, detected as HVD101 detects a collective;
    * a group created inside a loop (or comprehension) over a set or a
      dict, whose order differs across processes, as HVD103 detects one.
    """

    code = "HVD105"
    name = "divergent-group-creation"
    hint = ("create every group on every process, in a rank-invariant "
            "order (iterate sorted(...)), and pick this rank's group "
            "afterwards: groups = [dist.new_group(r) for r in layout]; "
            "mine = groups[index_of_my_group]")

    @staticmethod
    def _group_calls(tree: ast.AST) -> list[ast.Call]:
        return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and call_name(n) in GROUP_CALLS]

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple[int, int]] = set()

        def add(node: ast.Call, message: str) -> None:
            key = (node.lineno, node.col_offset)
            if key not in seen:
                seen.add(key)
                out.append(self.finding(node, message))

        for _node, body, orelse in rank_branches(ctx.module, ctx):
            body_calls = [c for stmt in body
                          for c in self._group_calls(stmt)]
            else_calls = [c for stmt in orelse
                          for c in self._group_calls(stmt)]
            if [ast.dump(c) for c in body_calls] == \
                    [ast.dump(c) for c in else_calls]:
                continue
            for c in body_calls + else_calls:
                add(c, (f"'{call_name(c)}' is reached under a rank-"
                        f"dependent condition whose branches create "
                        f"different groups: every process must create "
                        f"every group in the same order, members or not, "
                        f"or later groups pair up wrongly and hang"))
        for node in ast.walk(ctx.module):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                scopes = [(node.iter, node.body + node.orelse)]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                elt = [node.key, node.value] if isinstance(
                    node, ast.DictComp) else [node.elt]
                scopes = [(comp.iter, elt) for comp in node.generators]
            else:
                continue
            for it, body in scopes:
                if not unordered_iter(it):
                    continue
                for c in (c for stmt in body
                          for c in self._group_calls(stmt)):
                    add(c, (f"'{call_name(c)}' inside a loop over an "
                            f"unordered set/dict: iteration order differs "
                            f"across processes, so processes create their "
                            f"groups in different orders and pair them "
                            f"wrongly"))
        return out


class StaleTopologyConstant(Rule):
    """``hvd.size()``/``hvd.rank()`` cached where elastic resize can't
    reach it: a module- or class-level constant, or a default parameter
    value (frozen at ``def`` time — the classic closure-constant idiom).

    Under ``HVD_TPU_ELASTIC=1`` a membership reconfiguration reassigns
    ranks and changes the world size *inside a live process*: every such
    cached value is silently stale afterwards — wrong data shards, wrong
    LR scale, wrong rank-0 gating.  Exempt: names that are refreshed
    inside an ``on_reconfigure`` callback (``elastic.on_reconfigure``),
    which is exactly where such caches belong.
    """

    code = "HVD106"
    name = "stale-topology-constant"
    hint = ("call hvd.size()/hvd.rank() at use time, or refresh the cached "
            "value inside an @hvd.on_reconfigure callback (elastic resize "
            "changes both in a live process)")

    _TOPO = frozenset({"rank", "size", "local_rank", "local_size",
                       "cross_rank", "cross_size", "num_chips"})
    _ROOTS = frozenset({"horovod_tpu_torch", "hvd"})

    def _topo_call(self, ctx: Context, node: ast.AST) -> str | None:
        """Dotted path of a zero-arg topology call inside ``node``."""
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Call) and not sub.args
                    and not sub.keywords):
                continue
            path = dotted(sub.func)
            if path is None or path.split(".")[-1] not in self._TOPO:
                continue
            # Bare ``size()`` only counts when imported from the package;
            # ``q.size()`` on some queue object must not trip the rule.
            if "." not in path and ctx.resolve(path) == path:
                continue
            if ctx.resolve(path).split(".")[0] in self._ROOTS:
                return path
        return None

    @staticmethod
    def _is_on_reconfigure(deco: ast.expr) -> bool:
        target = deco.func if isinstance(deco, ast.Call) else deco
        path = dotted(target)
        return path is not None and path.split(".")[-1] == "on_reconfigure"

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        # Names some on_reconfigure callback refreshes are exempt — the
        # cache is elastic-aware by construction.
        refreshed: set[str] = set()
        for node in ast.walk(ctx.module):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(self._is_on_reconfigure(d)
                       for d in node.decorator_list):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Assign, ast.AugAssign,
                                    ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                refreshed.add(n.id)

        def scan_body(body: list[ast.stmt]) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    value = getattr(stmt, "value", None)
                    if value is None:
                        continue
                    path = self._topo_call(ctx, value)
                    if path is None:
                        continue
                    targets = stmt.targets if isinstance(stmt, ast.Assign) \
                        else [stmt.target]
                    names = {n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name)}
                    if names and names <= refreshed:
                        continue
                    out.append(self.finding(stmt, (
                        f"'{path}()' cached into a module/class-level "
                        f"constant: an elastic membership resize "
                        f"(HVD_TPU_ELASTIC) changes rank/size in a live "
                        f"process, leaving this value silently stale")))
                elif isinstance(stmt, ast.ClassDef):
                    scan_body(stmt.body)

        scan_body(ctx.module.body)
        for node in ast.walk(ctx.module):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                path = self._topo_call(ctx, d)
                if path is not None:
                    out.append(self.finding(d, (
                        f"'{path}()' used as a default parameter value of "
                        f"'{node.name}': defaults are evaluated once at "
                        f"def time and go stale when an elastic resize "
                        f"(HVD_TPU_ELASTIC) changes rank/size")))
        return out


class HandTunedOverlapKnob(Rule):
    """Code that WRITES the overlap-bucket env knob.

    The schedule planner (ops/schedule_plan.py) chooses the chained-bucket
    depth per program from width, gradient manifest, and device headroom;
    a hand-set ``HOROVOD_OVERLAP_BUCKETS`` / ``HVD_TPU_OVERLAP_BUCKETS``
    pins the legacy StaticPlanner and silently opts the job out of the
    width-1 bypass and the headroom-deficit degradation.  Reading the knob
    is fine; writing it from code is almost never what a new job wants.
    Test fixtures that pin the legacy branch on purpose carry
    ``# hvd-lint: disable=HVD107`` — that is the sanctioned idiom, not a
    recommendation.
    """

    code = "HVD107"
    name = "hand-tuned-overlap-knob"
    hint = ("let the AdaptivePlanner choose the chain depth (it bypasses "
            "at width 1 and degrades under headroom pressure); if you "
            "really need the legacy static behavior, pass overlap_buckets= "
            "or planner=StaticPlanner(...) in code, and mark deliberate "
            "test fixtures with `# hvd-lint: disable=HVD107`")

    _KNOBS = frozenset({"HOROVOD_OVERLAP_BUCKETS",
                        "HVD_TPU_OVERLAP_BUCKETS"})
    _SET_CALLS = frozenset({"setenv", "putenv", "setdefault"})

    def _knob_const(self, node: ast.expr | None) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value in self._KNOBS)

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.module):
            if isinstance(node, ast.Assign):
                # os.environ["HOROVOD_OVERLAP_BUCKETS"] = ...
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            self._knob_const(t.slice):
                        out.append(self.finding(node, (
                            "environment write hand-sets the overlap-"
                            "bucket knob: the schedule planner already "
                            "adapts chain depth to width and headroom")))
            elif isinstance(node, ast.Call) and \
                    call_name(node) in self._SET_CALLS:
                # monkeypatch.setenv(...) / os.putenv(...) /
                # os.environ.setdefault(...)
                if node.args and self._knob_const(node.args[0]):
                    out.append(self.finding(node, (
                        f"'{call_name(node)}' hand-sets the overlap-bucket "
                        f"knob: the schedule planner already adapts chain "
                        f"depth to width and headroom")))
        return out


class PlainCausalRing(Rule):
    """Causal attention on the plain ring layout.

    The context planner (ops/schedule_plan.py ``plan_context``) routes
    causal multi-shard work to the zigzag layout: on the plain ring, rank
    r's first ``n-1-r`` steps attend fully-masked K blocks (the planner
    retires that idle triangle).  Calling ``ring_flash_attention(q, k, v,
    group=None, causal=True)`` with ``causal=True`` (or leaving it to its
    True default; ``causal`` is argument 4) opts out of that by accident.

    The JAX rule's other half, integer-literal ``block_q``/``block_k``
    tiles, has no counterpart: the port's ring entry points take no tile
    arguments (the kernels choose their own tiles).  Audit/fixture sites
    that pin the plain causal path on purpose carry
    ``# hvd-lint: disable=HVD108``.
    """

    code = "HVD108"
    name = "plain-causal-ring"
    hint = ("derive the layout from the plan: ops/schedule_plan."
            "plan_context (parallel/context.py wires it into a "
            "TransformerConfig); mark deliberate plain-causal fixtures "
            "with `# hvd-lint: disable=HVD108`")

    _CAUSAL_INDEX = 4

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.module):
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "ring_flash_attention"):
                continue
            causal = (node.args[self._CAUSAL_INDEX]
                      if len(node.args) > self._CAUSAL_INDEX
                      else kwarg(node, "causal"))
            if causal is None or (isinstance(causal, ast.Constant)
                                  and causal.value is True):
                out.append(self.finding(node, (
                    "causal attention on the plain ring layout: rank "
                    "r's first n-1-r steps attend fully-masked K "
                    "blocks — plan_context routes causal multi-shard "
                    "work to the zigzag layout instead")))
        return out


class UnbucketedServeShape(Rule):
    """Request-length-shaped inputs to a compiled function in a serve loop.

    A serving loop calls its compiled prefill/decode once per request (or
    per step).  ``torch.compile`` (with ``dynamic=False``, or before it
    marks a dimension dynamic) guards on every input shape and compiles a
    new frame for each novel one, and a ``torch.cuda.make_graphed_callables``
    graph exists for one shape only, so each novel length needs a new
    capture.  An argument whose shape is derived from ``len(prompt)`` —
    ``torch.zeros((len(p), ...))``, ``tokens[:len(p)]`` — therefore
    recompiles (or re-captures) for every novel request length: tail
    latency absorbs the compile mid-traffic, the recompile limit is
    reached and the function falls back to eager, and on a fleet the
    ranks' response caches never warm because every shape is a fresh
    negotiation.  The serving engine's contract (serving/engine.py,
    ``ServingConfig.buckets``) is a fixed bucket menu: pad the prompt to
    the smallest bucket that holds it and pass the true length as a
    SCALAR.  Passing ``len(p)`` as a plain argument is accordingly fine;
    only shape-position uses are flagged.

    Callees considered serve-loop entry points: names bound from
    ``torch.compile(...)`` or ``torch.cuda.make_graphed_callables(...)``
    in the same module, and ``prefill``/``decode``-named calls (the
    backend protocol's verbs).  Deliberate one-shape fixtures carry
    ``# hvd-lint: disable=HVD109``.
    """

    code = "HVD109"
    name = "unbucketed-serve-shape"
    hint = ("pad the prompt to a fixed bucket (ServingConfig.buckets; "
            "smallest bucket >= len(prompt)) and pass the true length as "
            "a scalar argument — one compile per bucket, not per request "
            "length; mark deliberate one-shape fixtures with "
            "`# hvd-lint: disable=HVD109`")

    _SHAPE_CTORS = frozenset({"zeros", "ones", "full", "empty", "arange",
                              "randn", "rand", "randint"})
    _SERVE_VERBS = ("prefill", "decode")
    _COMPILERS = ("torch.compile", "make_graphed_callables")

    @classmethod
    def _compiled_names(cls, ctx: Context) -> frozenset[str]:
        """Names assigned from ``torch.compile(...)`` /
        ``make_graphed_callables(...)`` — including ``self.f = ...``
        method-style bindings and tuple targets."""
        out: set[str] = set()
        for node in ast.walk(ctx.module):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            resolved = ctx.resolved(node.value)
            if resolved is None or not resolved.endswith(cls._COMPILERS):
                continue
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
                    elif isinstance(n, ast.Attribute):
                        out.add(n.attr)
        return frozenset(out)

    @classmethod
    def _len_shaped(cls, arg: ast.expr) -> ast.AST | None:
        """A node inside ``arg`` whose SHAPE depends on ``len(...)``:
        a shape-constructor with len() in its arguments, or a slice
        bounded by len().  Scalar len() uses return None."""
        for node in ast.walk(arg):
            if isinstance(node, ast.Call) and \
                    call_name(node) in cls._SHAPE_CTORS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and \
                            call_name(sub) == "len":
                        return node
            elif isinstance(node, ast.Subscript):
                for sub in ast.walk(node.slice):
                    if isinstance(sub, ast.Call) and \
                            call_name(sub) == "len":
                        return node
        return None

    def run(self, ctx: Context) -> list[Finding]:
        compiled = self._compiled_names(ctx)
        out: list[Finding] = []
        for loop in ast.walk(ctx.module):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                cname = call_name(node)
                if cname is None:
                    continue
                is_serve = cname in compiled or any(
                    v in cname.lower() for v in self._SERVE_VERBS)
                if not is_serve:
                    continue
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    if self._len_shaped(arg) is not None:
                        out.append(self.finding(node, (
                            f"'{cname}' is called in a serve loop with an "
                            f"argument shaped by len(...): a recompile "
                            f"(torch.compile) or a new CUDA graph per "
                            f"novel request length, and a cold response "
                            f"cache in the fleet")))
                        break
        return out


class CollectiveBeforeReconfigure(Rule):
    """Collective issued inside ``except MembershipChanged:`` before
    ``elastic.reconfigure()``.

    ``MembershipChanged`` (core/engine.py) means the membership epoch just
    bumped: the engine that raised it is stopping, every in-flight
    collective is failing, and any frame stamped with the old epoch is
    rejected as ``stale_epoch`` by the new control plane (message.h
    FrameHeader).  Retrying the collective from the handler therefore
    hangs or aborts — the protocol model checker derives the wedge
    mechanically (analysis/protocol: the RECONFIG-in-wait interleavings).
    The contract is the serving/worker.py shape: call
    ``elastic.reconfigure()`` FIRST (it re-forms the control plane under
    the new epoch and returns the resize event), rebuild per-epoch state,
    then re-issue work.  Handlers that only clean up and re-raise are
    fine; only collectives issued before any ``reconfigure()`` call in
    the same handler are flagged.
    """

    code = "HVD110"
    name = "collective-before-reconfigure"
    hint = ("call elastic.reconfigure() before issuing collectives from a "
            "MembershipChanged handler (it re-forms the control plane "
            "under the new epoch; old-epoch frames are rejected as "
            "stale_epoch), then rebuild per-epoch state and retry")

    # The engine-level enqueue is how serving/background loops issue work
    # without the public wrappers; it speaks the same stale-epoch protocol.
    _RETRY_CALLS = COLLECTIVE_CALLS | {"enqueue"}

    def _catches_membership_changed(self, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return False
        types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
                 else [handler.type])
        for ty in types:
            path = dotted(ty)
            if path is not None and \
                    path.split(".")[-1] == "MembershipChanged":
                return True
        return False

    def run(self, ctx: Context) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.module):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not self._catches_membership_changed(handler):
                    continue
                calls = [c for stmt in handler.body
                         for c in ast.walk(stmt) if isinstance(c, ast.Call)]
                calls.sort(key=lambda c: (c.lineno, c.col_offset))
                reconfigured = False
                for c in calls:
                    cname = call_name(c)
                    if cname == "reconfigure":
                        reconfigured = True
                    elif ctx.is_collective(c, self._RETRY_CALLS) and \
                            not reconfigured:
                        out.append(self.finding(c, (
                            f"'{cname}' issued inside an "
                            f"'except MembershipChanged' handler before "
                            f"elastic.reconfigure(): the epoch just "
                            f"bumped, so the retry's frames are rejected "
                            f"as stale_epoch by the new control plane "
                            f"(or hang against the stopping engine)")))
        return out


RULES: list[Rule] = [
    RankDivergentCollective(),
    UnnamedCollectiveInLoop(),
    NondeterministicName(),
    ImpureCapturedStep(),
    DivergentGroupCreation(),
    StaleTopologyConstant(),
    HandTunedOverlapKnob(),
    PlainCausalRing(),
    UnbucketedServeShape(),
    CollectiveBeforeReconfigure(),
]
