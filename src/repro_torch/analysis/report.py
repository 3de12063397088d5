"""Violation / report plumbing shared by every analysis pass: the twin of
`repro.analysis.report`, with the same JSON layout (`ok`, `passes`, `root`,
`suppressed`, `violations`)."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Violation:
    """One finding. `path` is repo-relative, `line` 1-based (0 = whole-file
    or non-source finding). `suppressed` marks a finding covered by an
    `# analysis: allow(rule): reason` pragma: it stays in the report (the
    escape hatch is auditable) but does not fail the gate."""

    pass_name: str
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None

    def key(self) -> tuple:
        return (self.pass_name, self.rule, self.path, self.line)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = " [suppressed: %s]" % self.reason if self.suppressed else ""
        return f"{loc}: [{self.pass_name}/{self.rule}] {self.message}{tag}"


class Report:
    """Accumulates violations across passes; serializes
    CHECK_report_torch.json."""

    def __init__(self, root: str):
        self.root = root
        self.violations: list[Violation] = []
        self.pass_info: dict[str, dict] = {}

    def add(self, v: Violation) -> None:
        self.violations.append(v)

    def extend(self, vs) -> None:
        self.violations.extend(vs)

    def note(self, pass_name: str, **info) -> None:
        """Attach per-pass metadata (files scanned, kernels checked, ...)."""
        self.pass_info.setdefault(pass_name, {}).update(info)

    @property
    def active(self) -> list[Violation]:
        return [v for v in self.violations if not v.suppressed]

    @property
    def suppressed(self) -> list[Violation]:
        return [v for v in self.violations if v.suppressed]

    @property
    def ok(self) -> bool:
        return not self.active

    def to_dict(self) -> dict:
        per_pass = {name: dict(info) for name, info in self.pass_info.items()}
        for v in self.violations:
            d = per_pass.setdefault(v.pass_name, {})
            k = "suppressed" if v.suppressed else "violations"
            d[k] = d.get(k, 0) + 1
        return {
            "root": self.root,
            "ok": self.ok,
            "passes": per_pass,
            "violations": [dataclasses.asdict(v) for v in self.active],
            "suppressed": [dataclasses.asdict(v) for v in self.suppressed],
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    def summary(self) -> str:
        lines = [v.format() for v in sorted(self.active, key=Violation.key)]
        lines += [v.format()
                  for v in sorted(self.suppressed, key=Violation.key)]
        lines.append(
            f"analysis: {len(self.active)} violation(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.pass_info)} pass(es) ran")
        return "\n".join(lines)
