"""Structured diagnostics (copy of flexflow_tpu/analysis/diagnostics.py).

Every finding carries a stable rule id (catalogued per pass), a severity,
the offending location (PCG node / tensor, or source file / line), a
human-readable message, and a fix hint. The memory verifier
(analysis/memory_analysis.py) reports in them; the budgeted search rejects
a candidate with any error among them.
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"


@dataclass(frozen=True)
class Diagnostic:
    rule_id: str
    severity: Severity
    message: str
    # PCG location (verifier passes)
    node: Optional[int] = None  # PCG node idx
    tensor: Optional[str] = None  # repr of the offending DataflowOutput/shape
    # source location (lint pass)
    path: Optional[str] = None
    line: Optional[int] = None
    hint: Optional[str] = None

    def to_json(self) -> dict:
        d = asdict(self)
        d["severity"] = self.severity.value
        return {k: v for k, v in d.items() if v is not None}


def human_bytes(n: float) -> str:
    """GiB/MiB/KiB rendering shared by the MEM/COMM/DON diagnostic
    families (one formatter, one diagnostic voice)."""
    for unit, scale in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= scale:
            return f"{n / scale:.2f} {unit}"
    return f"{n:.0f} B"


def error(rule_id: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(rule_id, Severity.ERROR, message, **kw)


def warning(rule_id: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(rule_id, Severity.WARNING, message, **kw)


def errors_of(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == Severity.ERROR]


def has_errors(diags: Sequence[Diagnostic]) -> bool:
    return any(d.severity == Severity.ERROR for d in diags)


def format_diagnostic(d: Diagnostic) -> str:
    loc = ""
    if d.path is not None:
        loc = f"{d.path}:{d.line if d.line is not None else '?'}: "
    at = []
    if d.node is not None:
        at.append(f"node={d.node}")
    if d.tensor is not None:
        at.append(f"tensor={d.tensor}")
    where = f" [{' '.join(at)}]" if at else ""
    hint = f" (hint: {d.hint})" if d.hint else ""
    return f"{loc}{d.rule_id} {d.severity.value}{where}: {d.message}{hint}"


def summarize(diags: Sequence[Diagnostic], max_detail: int = 20) -> dict:
    """Compact JSON summary for provenance records."""
    errs = errors_of(diags)
    return {
        "clean": not errs,
        "errors": len(errs),
        "warnings": len(diags) - len(errs),
        "diagnostics": [d.to_json() for d in list(diags)[:max_detail]],
    }
