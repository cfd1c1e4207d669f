"""hvdlint command line: ``python -m horovod_tpu_torch.analysis <paths>``.

Copied from ``horovod_tpu/analysis/cli.py``, with the passes the port
has: ``lint`` (the default), ``--race`` and ``--comm``.  The JAX
package's ``--mem`` pass (HVD300 / HVD301 over ``donate_argnums``) has
no torch construct to read.

Exit codes (the JAX CLI's contract):

* 0 — no unsuppressed findings
* 1 — at least one unsuppressed finding (including HVD000 parse
  failures: a file the linter cannot read is a finding, not a crash)
* 2 — usage error (argparse) or internal analyzer error

Text output prints one block per finding (location, rule, severity,
message, fix hint); ``--format json`` prints a single machine-readable
object with the findings plus per-rule statistics.

Passes are registered in ONE table (``PASSES``): name → walker, rule
range, default paths.  Adding an analyzer means adding a row — the
dispatch, flag wiring, select/ignore filtering (prefix-matching:
``--select HVD2`` runs the whole HVD2xx family), pragma handling, and
the exit-code contract all come for free and stay identical across
lint (HVD0xx), ``--race`` (HVD2xx) and ``--comm`` (HVD404).  ``--all``
runs every registered pass over ONE shared file walk, prints the
combined (per-pass) output, and exits with the MAX of the per-pass exit
codes — the one-invocation CI gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

from .findings import RULES, unsuppressed


def _split_ids(value: str) -> List[str]:
    return [tok.strip().upper() for tok in value.split(",") if tok.strip()]


# ---------------------------------------------------------------------------
# Pass registry
# ---------------------------------------------------------------------------

def _run_lint(paths, select, ignore):
    from .linter import lint_paths
    return lint_paths(paths, select=select, ignore=ignore)


def _run_race(paths, select, ignore):
    from .lockgraph import analyze_paths
    return analyze_paths(paths, select=select, ignore=ignore)


def _run_comm(paths, select, ignore):
    from .shardplan import analyze_paths
    return analyze_paths(paths, select=select, ignore=ignore)


@dataclasses.dataclass(frozen=True)
class AnalyzerPass:
    """One analyzer: its CLI identity, rule family, and path walker."""

    name: str              # registry key; non-default passes get --<name>
    rules: str             # human-readable rule range for --help
    runner: Callable       # (paths, select, ignore) -> List[Finding]
    help: str
    default_paths: tuple = (".",)


PASSES: Dict[str, AnalyzerPass] = {
    "lint": AnalyzerPass(
        "lint", "HVD001-HVD011",
        _run_lint,
        "AST distributed-correctness rules (the default pass)"),
    "race": AnalyzerPass(
        "race", "HVD200-HVD203",
        _run_race,
        "hvdrace lock-order & thread-lifecycle analysis over the given "
        "paths as ONE global lock graph"),
    "comm": AnalyzerPass(
        "comm", "HVD404",
        _run_comm,
        "hvdshard dead mesh axes: a make_mesh axis that no spec, "
        "axis_name or reduce_axes in the function names"),
}
DEFAULT_PASS = "lint"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdlint",
        description="Distributed-correctness static analyzers for "
                    "horovod_tpu_torch (default pass: AST lint "
                    "HVD001-HVD011; --race HVD200-HVD203; --comm HVD404; "
                    "--all runs every pass)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to analyze (default: .)")
    mode = p.add_mutually_exclusive_group()
    for name, pass_ in PASSES.items():
        if name == DEFAULT_PASS:
            continue
        mode.add_argument(
            f"--{name}", action="store_true",
            help=f"run the {name} pass instead ({pass_.rules}): "
                 f"{pass_.help}; same output formats, pragmas, and "
                 f"exit codes")
    mode.add_argument(
        "--all", action="store_true",
        help="run EVERY registered pass "
             f"({', '.join(PASSES)}) over one shared file walk; "
             "combined per-pass output, exit = max of per-pass exits")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--select", type=_split_ids, default=[],
                   help="comma-separated rule IDs (or prefixes: HVD2 "
                        "selects all HVD2xx) to run exclusively")
    p.add_argument("--ignore", type=_split_ids, default=[],
                   help="comma-separated rule IDs/prefixes to skip")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print findings silenced by '# hvdlint: "
                        "disable=...' pragmas")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def _print_rules() -> None:
    for rule in RULES.values():
        print(f"{rule.id} [{rule.severity}] {rule.summary}")
        print(f"    fix: {rule.fix_hint}")


def _run_all(args) -> int:
    """Every registered pass over ONE shared directory walk: the paths
    are expanded to a concrete .py file list once (``iter_python_files``
    is idempotent on files, so each runner reuses the walk instead of
    re-crawling), per-pass results render under their pass name, and
    the exit code is the MAX of the per-pass exits (2 internal error >
    1 findings > 0 clean)."""
    from .linter import iter_python_files
    paths = args.paths if args.paths else ["."]
    missing = [p for p in paths if not os.path.exists(p)]
    shared_walk = iter_python_files(
        [p for p in paths if os.path.exists(p)])
    results: Dict[str, dict] = {}
    exit_code = 0
    for name, pass_ in PASSES.items():
        try:
            findings = pass_.runner(shared_walk + missing, args.select,
                                    args.ignore)
        except Exception as e:
            print(f"hvdlint: internal error in pass '{name}': "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            exit_code = max(exit_code, 2)
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        active = unsuppressed(findings)
        exit_code = max(exit_code, 1 if active else 0)
        shown = findings if args.show_suppressed else active
        results[name] = {
            "findings": [f.to_dict() for f in shown],
            "summary": {
                "total": len(active),
                "suppressed": len(findings) - len(active),
                "by_rule": dict(sorted(
                    Counter(f.rule for f in active).items())),
            },
        }
        if args.format != "json":
            for f in shown:
                print(f.format())
            suppressed_n = len(findings) - len(active)
            tail = f" ({suppressed_n} suppressed)" if suppressed_n else ""
            print(f"hvdlint [{name}]: {len(active)} finding(s){tail}")
    if args.format == "json":
        print(json.dumps({"pass": "all", "passes": results}, indent=1))
    return exit_code


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        _print_rules()
        return 0
    if args.all:
        try:
            return _run_all(args)
        except Exception as e:
            print(f"hvdlint: internal error: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
    chosen = [name for name in PASSES
              if name != DEFAULT_PASS and getattr(args, name, False)]
    pass_ = PASSES[chosen[0] if chosen else DEFAULT_PASS]
    paths = args.paths if args.paths else list(pass_.default_paths)
    try:
        findings = pass_.runner(paths, args.select, args.ignore)
    except Exception as e:  # internal error: distinct from "has findings"
        print(f"hvdlint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    active = unsuppressed(findings)
    shown = findings if args.show_suppressed else active
    if args.format == "json":
        by_rule = Counter(f.rule for f in active)
        print(json.dumps({
            "pass": pass_.name,
            "findings": [f.to_dict() for f in shown],
            "summary": {
                "total": len(active),
                "suppressed": len(findings) - len(active),
                "by_rule": dict(sorted(by_rule.items())),
            },
        }, indent=1))
    else:
        for f in shown:
            print(f.format())
        suppressed_n = len(findings) - len(active)
        tail = f" ({suppressed_n} suppressed)" if suppressed_n else ""
        print(f"hvdlint: {len(active)} finding(s){tail} in "
              f"{len(set(f.path for f in findings)) if findings else 0} "
              f"flagged file(s)")
    return 1 if active else 0
