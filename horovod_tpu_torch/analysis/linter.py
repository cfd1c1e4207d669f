"""hvdlint's linter: source → AST rules → suppression-filtered findings.

Copied from ``horovod_tpu/analysis/linter.py``.  Stdlib-only (ast + re,
no torch), so the rules run anywhere.

Suppression syntax (checked per finding line, plus file-wide):

* ``# hvdlint: disable=HVD001`` — suppress these rule IDs on this line
  (comma-separated list, or ``all``).
* ``# hvdlint: disable-file=HVD004`` — suppress for the whole file, on a
  comment line anywhere in the file.

Suppressed findings are still returned (``suppressed=True``) so tooling
can audit them; the CLI's exit code and the self-lint gate only count
unsuppressed ones.  A file that fails to parse produces a single HVD000
finding carrying the exception — the linter never raises on user input
(the loudly-but-gracefully contract).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from . import rules
from .findings import Finding

_PRAGMA = re.compile(
    r"#\s*hvdlint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\s]+)")


def _parse_pragmas(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Map line → suppressed rule IDs, plus the file-wide suppression set.

    Only real COMMENT tokens count — pragma-shaped text inside a string
    literal or docstring (e.g. documentation of the suppression syntax)
    must not silence anything, so the source is tokenized rather than
    regex-scanned line by line.  A tokenize failure (theoretically
    unreachable once ast.parse succeeded) yields NO pragmas: findings
    stay loud rather than silently suppressed."""
    per_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError,
            ValueError):
        return per_line, file_wide
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA.search(tok.string)
        if not m:
            continue
        ids = {t.strip().upper() for t in m.group(2).split(",")
               if t.strip()}
        if m.group(1) == "disable-file":
            file_wide |= ids
        else:
            per_line.setdefault(tok.start[0], set()).update(ids)
    return per_line, file_wide


def _suppressed(f: Finding, per_line: Dict[int, Set[str]],
                file_wide: Set[str]) -> bool:
    def hit(ids: Set[str]) -> bool:
        return "ALL" in ids or f.rule in ids
    if hit(file_wide):
        return True
    ids = per_line.get(f.line)
    return ids is not None and hit(ids)


def _rule_selected(rule: str, select: Sequence[str],
                   ignore: Sequence[str]) -> bool:
    """Shared filter (findings.rule_selected): select wins when both are
    given, tokens match exactly or as prefixes (``--select HVD3``), and
    the contract applies uniformly to every pass and rule — including
    HVD000 analysis failures."""
    from .findings import rule_selected
    return rule_selected(rule, select, ignore)


def lint_source(source: str, path: str = "<string>",
                select: Sequence[str] = (),
                ignore: Sequence[str] = ()) -> List[Finding]:
    """Lint one source string.  ``select``/``ignore`` filter by rule ID."""
    try:
        tree = ast.parse(source, filename=path)
    except (SyntaxError, ValueError, RecursionError) as e:
        if not _rule_selected("HVD000", select, ignore):
            return []
        line = getattr(e, "lineno", 0) or 0
        col = (getattr(e, "offset", 0) or 0)
        return [Finding(rule="HVD000", path=path, line=line, col=max(col, 1),
                        message=f"could not parse: {type(e).__name__}: {e}")]
    findings = rules.analyze(tree, path)
    per_line, file_wide = _parse_pragmas(source)
    out: List[Finding] = []
    for f in findings:
        if not _rule_selected(f.rule, select, ignore):
            continue
        f.suppressed = _suppressed(f, per_line, file_wide)
        out.append(f)
    return out


def lint_file(path: str, select: Sequence[str] = (),
              ignore: Sequence[str] = ()) -> List[Finding]:
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
        source = raw.decode("utf-8", errors="replace")
    except OSError as e:
        if not _rule_selected("HVD000", select, ignore):
            return []
        return [Finding(rule="HVD000", path=path, line=0, col=1,
                        message=f"could not read file: {e}")]
    return lint_source(source, path=path, select=select, ignore=ignore)


_SKIP_DIRS = {"__pycache__", ".git", "_build", "node_modules",
              "artifacts", ".venv", "venv", "build", "dist"}


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted, deduped .py file list.
    Nonexistent paths surface as HVD000 findings from lint_paths (not
    silently skipped)."""
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
        elif os.path.isdir(path):
            for root, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def lint_paths(paths: Iterable[str], select: Sequence[str] = (),
               ignore: Sequence[str] = ()) -> List[Finding]:
    """Lint every .py file under the given files/directories."""
    findings: List[Finding] = []
    files: List[str] = []
    for path in paths:
        if not os.path.exists(path):
            if _rule_selected("HVD000", select, ignore):
                findings.append(Finding(
                    rule="HVD000", path=path, line=0, col=1,
                    message="path does not exist"))
        else:
            files.append(path)
    for f in iter_python_files(files):
        findings.extend(lint_file(f, select=select, ignore=ignore))
    return findings
