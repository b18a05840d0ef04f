"""Finding/report types shared by the port's asaplint static passes."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Finding:
    """One static-analysis finding.

    `suppressed` is True when the flagged line carries an explicit
    `# race-ok: <reason>` (lock discipline), `# sync-ok: <reason>` (host
    syncs and launches under a lock), `kernel-ok` (launch contracts; `//`
    in a `.cu`) or `# shard-ok: <reason>` (dtype policy) annotation — the
    finding is still recorded (and lands in the JSON report) so triage
    decisions stay visible, but it does not fail the run.
    """
    rule: str  # e.g. "unguarded-access", "sync-uncounted"
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None  # the suppression's justification
    # comment line that discharged a suppressed finding — lets the
    # stale-suppression scan tell used annotations from rotted ones
    suppress_line: Optional[int] = None

    def format(self) -> str:
        tag = " [suppressed: {}]".format(self.reason) if self.suppressed \
            else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    # static lock-order graph: (holder, acquired) -> list of witness strings
    lock_edges: Dict[Tuple[str, str], List[str]]
    files: List[str]

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def to_dict(self) -> dict:
        return {
            "files": list(self.files),
            "findings": [f.to_dict() for f in self.findings],
            "lock_order": [{"from": a, "to": b, "witnesses": w}
                           for (a, b), w in sorted(self.lock_edges.items())],
            "summary": {"total": len(self.findings),
                        "unsuppressed": len(self.unsuppressed),
                        "suppressed": len(self.suppressed)},
        }

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
