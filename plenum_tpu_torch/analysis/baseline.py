"""Finding baseline — grandfathered findings with justifications.

The gate (tests/test_torch_lint_clean.py) must fail on NEW findings
while known, triaged ones ride along. Entries key on
(rule, path, symbol, message) — deliberately NOT on line numbers, so
unrelated edits that shift a file don't invalidate the baseline; a
count field absorbs several identical findings in one symbol.

Every entry carries a one-line ``justification``: a baseline without a
reason is just a muted bug. ``--write-baseline`` emits entries with a
TODO justification for the author to fill in before committing.
Entries that no longer match anything are reported as stale so the
baseline shrinks as code is fixed instead of fossilizing.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from plenum_tpu_torch.analysis.core import Finding

VERSION = 1

Key = Tuple[str, str, str, str]


def _key(f: Finding) -> Key:
    return (f.rule, f.path, f.symbol, f.message)


class Baseline:
    def __init__(self, entries: List[dict] = None):
        self.entries = list(entries or [])

    # ------------------------------------------------------------- load/save

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls([])
        if data.get("version") != VERSION:
            raise ValueError(
                "unsupported lint baseline version %r in %s"
                % (data.get("version"), path))
        return cls(data.get("entries", []))

    def save(self, path: str) -> None:
        data = {"version": VERSION, "entries": self.entries}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=False)
            f.write("\n")

    @classmethod
    def from_findings(cls, findings: List[Finding],
                      justification: str = "TODO: justify or fix"
                      ) -> "Baseline":
        counts: Dict[Key, int] = {}
        order: List[Key] = []
        for f in findings:
            k = _key(f)
            if k not in counts:
                order.append(k)
            counts[k] = counts.get(k, 0) + 1
        entries = []
        for rule, path, symbol, message in order:
            e = {"rule": rule, "path": path, "symbol": symbol,
                 "message": message,
                 "justification": justification}
            n = counts[(rule, path, symbol, message)]
            if n > 1:
                e["count"] = n
            entries.append(e)
        return cls(entries)

    # ------------------------------------------------------------- matching

    def match(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding]]:
        """→ (new, baselined). Consumes entry counts so a baseline entry
        absorbs at most `count` findings (default 1)."""
        budget: Dict[Key, int] = {}
        for e in self.entries:
            k = (e["rule"], e["path"], e.get("symbol", ""), e["message"])
            budget[k] = budget.get(k, 0) + int(e.get("count", 1))
        new, old = [], []
        for f in findings:
            k = _key(f)
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                old.append(f)
            else:
                new.append(f)
        self._leftover = {k: v for k, v in budget.items() if v > 0}
        return new, old

    def stale(self) -> List[Key]:
        """Entry keys (with remaining budget) the last match() never
        consumed — candidates for deletion."""
        return sorted(getattr(self, "_leftover", {}))
