"""Per-file facts cache keyed by content hash.

Parsing + extraction is the only expensive step of the engine (linking
and summaries are dict-walks), and it is per-file and deterministic —
the textbook shape for a content-addressed cache. Entries key on the
sha256 of the file BYTES (not mtime: a ``git checkout`` back and forth
must re-hit, an edit must miss) plus the extractor version, so bumping
``symtab.FACTS_VERSION`` invalidates every entry at once.

The cache lives at ``<root>/.plenum_lint_torch_cache.json``
(gitignored), apart from the JAX package's analyzer's, so that the two
gates may run side by side without sharing a file.
All I/O is best-effort: a corrupt, unreadable or unwritable cache
degrades to a cold run, never to an error — the tier-1 gate must not
depend on scratch-file health. Writes are atomic (tmp + rename) so a
killed run can't leave a truncated JSON behind.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

from plenum_tpu_torch.analysis.engine.symtab import FACTS_VERSION

CACHE_BASENAME = ".plenum_lint_torch_cache.json"
CACHE_SCHEMA = 1


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class FactsCache:
    def __init__(self, path: Optional[str]):
        """path=None disables persistence (in-memory only)."""
        self.path = path
        self.entries: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._load()

    @classmethod
    def for_root(cls, root: str) -> "FactsCache":
        return cls(os.path.join(root, CACHE_BASENAME))

    def _load(self) -> None:
        if not self.path:
            return
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict) \
                or data.get("schema") != CACHE_SCHEMA \
                or data.get("facts_version") != FACTS_VERSION:
            return
        entries = data.get("entries")
        if isinstance(entries, dict):
            self.entries = entries

    def get(self, rel_path: str, sha: str) -> Optional[dict]:
        e = self.entries.get(rel_path)
        if e and e.get("sha") == sha:
            self.hits += 1
            return e.get("facts")
        self.misses += 1
        return None

    def put(self, rel_path: str, sha: str, facts: dict) -> None:
        self.entries[rel_path] = {"sha": sha, "facts": facts}
        self._dirty = True

    def prune(self, keep_rel_paths) -> None:
        """Drop entries for files no longer in the scan set so the
        cache tracks the tree instead of growing forever."""
        keep = set(keep_rel_paths)
        stale = [k for k in self.entries if k not in keep]
        for k in stale:
            del self.entries[k]
            self._dirty = True

    def save(self) -> None:
        if not self.path or not self._dirty:
            return
        data = {"schema": CACHE_SCHEMA, "facts_version": FACTS_VERSION,
                "entries": self.entries}
        try:
            d = os.path.dirname(self.path) or "."
            fd, tmp = tempfile.mkstemp(prefix=CACHE_BASENAME,
                                       dir=d, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f, separators=(",", ":"))
            os.replace(tmp, self.path)
            self._dirty = False
        except OSError:
            try:
                os.unlink(tmp)
            except (OSError, UnboundLocalError):
                pass
