"""hvd-lint for the PyTorch port — static collective-safety analyzer.

Usage::

    python -m horovod_tpu_torch.analysis.lint [--list-rules] <paths...>

Walks ``.py`` files (directories recurse), runs the rule catalog
(:mod:`horovod_tpu_torch.analysis.rules`; ``--list-rules`` prints it), and
prints one line per finding::

    path/to/file.py:12:4: HVD101 collective 'allreduce' is only ... [hint: ...]

Exit status: 0 clean, 1 findings, 2 bad invocation.  Suppress a finding
with a trailing comment on the flagged line::

    h = hvd.allreduce_async(x)  # hvd-lint: disable=HVD102

``disable=all`` silences every rule for that line.  Unparsable files are
reported as ``HVD000`` (they would not survive import on any rank either).

Pure stdlib by design: the analyzer must run anywhere — CI boxes, user
laptops, the card's host — without importing torch or building the native
engine.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass

from horovod_tpu_torch.analysis import rules as rules_mod
from horovod_tpu_torch.analysis.rules import RULES, Context, Finding

_DISABLE_RE = re.compile(r"#\s*hvd-lint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class LintError:
    """One reported finding, located in a file."""

    path: str
    line: int
    col: int
    code: str
    message: str
    hint: str

    def render(self) -> str:
        hint = f" [hint: {self.hint}]" if self.hint else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"{self.message}{hint}")


def _suppressions(source: str) -> dict[int, set[str]]:
    """line number -> set of disabled codes (or {"all"})."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(text)
        if m:
            codes = {c.strip().upper() if c.strip().lower() != "all"
                     else "all" for c in m.group(1).split(",") if c.strip()}
            out[i] = codes
    return out


def lint_source(source: str, path: str = "<string>") -> list[LintError]:
    """Lint one module's source; returns unsuppressed findings in
    (line, col, code) order."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintError(path, e.lineno or 1, (e.offset or 1) - 1, "HVD000",
                          f"syntax error: {e.msg}", "fix the parse error")]
    ctx = Context(tree)
    findings: list[Finding] = []
    for rule in RULES:
        findings.extend(rule.run(ctx))
    suppressed = _suppressions(source)
    out = []
    for f in findings:
        codes = suppressed.get(f.line, ())
        if "all" in codes or f.code in codes:
            continue
        out.append(LintError(path, f.line, f.col, f.code, f.message, f.hint))
    return sorted(out, key=lambda e: (e.line, e.col, e.code))


def iter_py_files(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def lint_paths(paths: list[str]) -> list[LintError]:
    out: list[LintError] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            out.append(LintError(path, 1, 0, "HVD000",
                                 f"cannot read file: {e}", ""))
            continue
        out.extend(lint_source(src, path))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.lint",
        description="static collective-safety analyzer for "
                    "horovod_tpu_torch training scripts")
    ap.add_argument("paths", nargs="*", help=".py files or directories")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.code} {rule.name}: {doc}")
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        return 2
    errors = lint_paths(args.paths)
    for e in errors:
        print(e.render())
    nfiles = len(iter_py_files(args.paths))
    if errors:
        print(f"hvd-lint: {len(errors)} finding(s) in {nfiles} file(s)",
              file=sys.stderr)
        return 1
    print(f"hvd-lint: {nfiles} file(s) clean "
          f"({len(rules_mod.RULES)} rules)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
