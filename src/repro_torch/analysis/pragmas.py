"""The `# analysis: allow(...)` pragma, the lint escape hatch (the twin of
`repro.analysis.pragmas`).

Grammar (one physical line, same line as the finding or the line above):

    # analysis: allow(rule-name): reason text
    # analysis: allow(rule-a, rule-b): reason text

The reason is REQUIRED. A pragma with an empty reason suppresses nothing
and is itself reported as `pragma-missing-reason`: the escape hatch must
leave an auditable justification behind (suppressed findings are kept in
the report with their reasons).
"""

from __future__ import annotations

import re
from typing import Optional

from repro_torch.analysis.report import Violation

_PRAGMA = re.compile(
    r"#\s*analysis:\s*allow\(\s*([a-zA-Z0-9_,\s-]+?)\s*\)\s*:?\s*(.*?)\s*$")


class PragmaIndex:
    """Per-file map of line -> (rules, reason) plus the malformed ones."""

    def __init__(self, path: str, source: str):
        self.path = path
        self._by_line: dict[int, tuple[frozenset[str], str]] = {}
        self.errors: list[Violation] = []
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = _PRAGMA.search(text)
            if not m:
                continue
            rules = frozenset(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            reason = m.group(2).strip()
            if not rules or not reason:
                self.errors.append(Violation(
                    pass_name="pragmas", rule="pragma-missing-reason",
                    path=path, line=lineno,
                    message="analysis pragma needs a rule list AND a "
                            "non-empty reason: "
                            "`# analysis: allow(rule): why`"))
                continue
            self._by_line[lineno] = (rules, reason)

    def lookup(self, rule: str, line: int) -> Optional[str]:
        """Reason suppressing `rule` at `line` (same line or the line
        above), or None."""
        for cand in (line, line - 1):
            entry = self._by_line.get(cand)
            if entry and rule in entry[0]:
                return entry[1]
        return None

    def apply(self, v: Violation) -> Violation:
        """Mark a violation suppressed if a pragma covers it."""
        reason = self.lookup(v.rule, v.line)
        if reason is not None:
            v.suppressed = True
            v.reason = reason
        return v


class PragmaCache:
    """One PragmaIndex per file, shared by every source pass so malformed
    pragmas are reported exactly once (by whichever pass touches the file
    first: check.py hands one cache to all of them)."""

    def __init__(self, report):
        self._report = report
        self._indexes: dict[str, PragmaIndex] = {}

    def get(self, path: str, source: str) -> PragmaIndex:
        idx = self._indexes.get(path)
        if idx is None:
            idx = PragmaIndex(path, source)
            self._indexes[path] = idx
            self._report.extend(idx.errors)
        return idx
