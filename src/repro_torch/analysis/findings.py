"""Structured findings of the static route-program verifier.

The port's copy of ``repro.analysis.findings``.  A :class:`Finding` is one
violated contract: a stable rule id (the reference's catalog, ``PC1xx``
for program verification), a human message, and the locus it anchors to.
Checks *return* findings instead of raising so callers can collect,
filter or report them; :class:`ProgramVerificationError` is the raising
wrapper the control plane uses to refuse installing an unsound route
program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

#: Severities.  ``error`` findings fail the CLI / raise in the control
#: plane; ``warning`` findings are reported but never gate.
ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One violated contract, anchored to a source or logical locus."""

    rule: str                 # stable id, e.g. "BL201" / "PC108" / "JA301"
    message: str
    path: str = ""            # file path, or logical locus ("program")
    line: int = 0             # 1-based source line; 0 = not a source locus
    severity: str = ERROR

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else (self.path or "-")
        return f"{loc}: {self.rule} [{self.severity}] {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "message": self.message,
                "path": self.path, "line": self.line,
                "severity": self.severity}


def errors(findings: Sequence[Finding]) -> List[Finding]:
    """The gating subset: findings with ``error`` severity."""
    return [f for f in findings if f.severity == ERROR]


class ProgramVerificationError(ValueError):
    """A RouteProgram failed static verification; carries the findings.

    Raised by ``ControlPlane.route_program(verify=True)`` instead of
    silently installing a program whose schedule would drop, duplicate or
    collide traffic.  ``.findings`` holds the full structured list.
    """

    def __init__(self, findings: Sequence[Finding]):
        self.findings: List[Finding] = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"route program failed static verification "
            f"({len(self.findings)} finding(s)):\n  {lines}")
