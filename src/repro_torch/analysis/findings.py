"""Finding records + the allowlist that keeps the lint gate strict but
green (port of ``repro.analysis.findings``, unchanged but for the
allowlist's path).

A finding pins a rule violation to ``path:line`` inside a dotted
``symbol`` (the enclosing class/function qualname).  The allowlist,
``src/repro_torch/analysis/allowlist.toml``, matches on ``(rule, path,
symbol)`` — never on line numbers, which drift — and every entry carries
a one-line ``reason``.  An entry that stops matching anything is itself
an error, so stale exemptions cannot accumulate.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

try:                                     # py3.11+
    import tomllib as _toml
except ImportError:                      # py3.10: the tomli backport
    import tomli as _toml

DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(__file__), "allowlist.toml")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a specific source location."""

    rule: str        # rule id, e.g. "rng-generator-fanout"
    path: str        # repo-relative posix path
    line: int
    symbol: str      # dotted qualname of the enclosing def, "" at module scope
    message: str

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    path: str
    symbol: str      # "" matches module scope; otherwise exact qualname
    reason: str

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule
                and f.path.endswith(self.path)
                and self.symbol == f.symbol)


def load_allowlist(path: str = DEFAULT_ALLOWLIST) -> List[AllowEntry]:
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        doc = _toml.load(fh)
    entries = []
    for row in doc.get("allow", []):
        missing = {"rule", "path", "reason"} - set(row)
        if missing:
            raise ValueError(f"allowlist entry missing {sorted(missing)}: {row}")
        entries.append(AllowEntry(rule=row["rule"], path=row["path"],
                                  symbol=row.get("symbol", ""),
                                  reason=row["reason"]))
    return entries


def apply_allowlist(
    findings: Sequence[Finding], entries: Sequence[AllowEntry],
) -> Tuple[List[Finding], List[AllowEntry]]:
    """Split findings into (kept, ...) and report stale allowlist entries.

    Returns ``(kept_findings, stale_entries)``: a finding is dropped when
    any entry matches it; an entry is stale when it matched nothing —
    stale entries should fail the gate so the allowlist tracks reality.
    """
    used: Dict[int, bool] = {i: False for i in range(len(entries))}
    kept: List[Finding] = []
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if e.matches(f):
                used[i] = True
                hit = True
        if not hit:
            kept.append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return kept, stale
