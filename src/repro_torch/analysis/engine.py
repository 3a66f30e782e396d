"""hfellint engine: findings, pragma suppression, file walking. Port of
``repro.analysis.engine``, over the port's rules
(:mod:`repro_torch.analysis.rules`).

The engine is deliberately stdlib-only (``ast`` + ``hashlib``): linting
stays cheap enough to run inside the test suite (``scripts/torch_lint.py
--check`` and ``tests/test_torch_lint.py``), before torch ever imports.

Suppression: a finding is silenced by an inline pragma on its own line or on
the line directly above::

    tmp = f"{int(time.time() * 1e6)}"  # hfellint: disable=HFEL002 -- wall-clock tmp name

The ``-- <justification>`` part is REQUIRED — a pragma without one does not
suppress anything and is itself reported (``HFEL000``), so every baselined
exception carries its reason in the source.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from dataclasses import dataclass

PRAGMA_RE = re.compile(
    r"#\s*hfellint:\s*disable=(?P<rules>[A-Z0-9,\s]+?)"
    r"(?:\s*--\s*(?P<why>\S.*))?\s*$")

#: directories never descended into by :func:`lint_paths`
SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


@dataclass(frozen=True)
class Finding:
    """One lint finding, identified across commits by :meth:`fingerprint`."""

    rule: str       # e.g. "HFEL003"
    path: str       # repo-relative, forward slashes
    lineno: int     # 1-based
    col: int        # 0-based
    message: str
    line: str       # the stripped source line (fingerprint component)

    def fingerprint(self) -> str:
        """Line-number-independent identity: rule + path + stripped source
        line. Stable across unrelated edits above/below the finding; two
        identical lines in one file share a fingerprint, which the baseline
        handles by counting."""
        h = hashlib.sha1(
            f"{self.rule}:{self.path}:{self.line}".encode())
        return h.hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.lineno}:{self.col + 1}: "
                f"{self.rule} {self.message}")


def _suppressions(lines: list[str]) -> tuple[dict[int, set[str]],
                                             list[tuple[int, str]]]:
    """(line -> suppressed rule ids, malformed pragmas as (lineno, text)).

    A pragma suppresses its own line; a pragma on a comment-only line also
    suppresses the next line (so long justifications fit above the code)."""
    supp: dict[int, set[str]] = {}
    malformed: list[tuple[int, str]] = []
    for i, raw in enumerate(lines, start=1):
        m = PRAGMA_RE.search(raw)
        if not m:
            continue
        if not m.group("why"):
            malformed.append((i, raw.strip()))
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        supp.setdefault(i, set()).update(rules)
        if raw.lstrip().startswith("#"):
            supp.setdefault(i + 1, set()).update(rules)
    return supp, malformed


def lint_source(path: str, text: str) -> list[Finding]:
    """Lint one file's source; returns findings sorted by position.

    ``path`` should be repo-relative — it scopes the path-sensitive rules
    (HFEL003 reads ``src/repro_torch/core/`` and ``kernels/``, HFEL005 the
    kernels) and feeds the fingerprint.
    """
    from repro_torch.analysis import rules as _rules

    path = path.replace(os.sep, "/")
    lines = text.splitlines()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        line = lines[e.lineno - 1].strip() if (
            e.lineno and e.lineno <= len(lines)) else ""
        return [Finding("HFEL000", path, e.lineno or 1, 0,
                        f"file does not parse: {e.msg}", line)]
    findings = _rules.run_rules(tree, path, lines)

    supp, malformed = _suppressions(lines)
    for lineno, pragma in malformed:
        findings.append(Finding(
            "HFEL000", path, lineno, 0,
            "hfellint pragma without a `-- justification`; it suppresses "
            "nothing until a reason is given", pragma))
    out = [f for f in findings
           if f.rule not in supp.get(f.lineno, ()) or f.rule == "HFEL000"]
    return sorted(out, key=lambda f: (f.lineno, f.col, f.rule))


def iter_python_files(targets: list[str], root: str = ".") -> list[str]:
    """Expand files/directories to a sorted repo-relative .py file list."""
    out: set[str] = set()
    for t in targets:
        full = t if os.path.isabs(t) else os.path.join(root, t)
        if os.path.isfile(full):
            out.add(os.path.relpath(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in SKIP_DIRS
                                 and not d.startswith("."))
            for name in filenames:
                if name.endswith(".py"):
                    out.add(os.path.relpath(os.path.join(dirpath, name),
                                            root))
    return sorted(p.replace(os.sep, "/") for p in out)


def lint_paths(targets: list[str], root: str = ".") -> list[Finding]:
    """Lint every ``.py`` file under ``targets`` (files or directories),
    resolved relative to ``root``; findings carry root-relative paths."""
    findings: list[Finding] = []
    for rel in iter_python_files(targets, root):
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            text = f.read()
        findings.extend(lint_source(rel, text))
    return findings
