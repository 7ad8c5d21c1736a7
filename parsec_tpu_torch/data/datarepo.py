"""Data repos: hand-off of produced data from tasks to their consumers.

Reference: ``parsec/datarepo.{c,h}`` — a per-task-class hash
keyed by task key; a completing task deposits its output copies with a usage
limit equal to the number of consumers; each consumer lookup decrements the
count and the entry is reclaimed at zero.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class RepoEntry:
    __slots__ = ("key", "copies", "usage_limit", "usage_count", "_retained")

    def __init__(self, key: Any, nb_flows: int):
        self.key = key
        self.copies: List[Optional[object]] = [None] * nb_flows
        self.usage_limit = 0
        self.usage_count = 0
        self._retained = False


class DataRepo:
    def __init__(self, nb_flows: int = 1, name: str = "repo"):
        self.nb_flows = nb_flows
        self.name = name
        self._table: Dict[Any, RepoEntry] = {}
        self._lock = threading.Lock()

    def lookup_and_create(self, key: Any) -> RepoEntry:
        """Reference ``data_repo_lookup_entry_and_create``."""
        with self._lock:
            e = self._table.get(key)
            if e is None:
                e = self._table[key] = RepoEntry(key, self.nb_flows)
            return e

    def lookup(self, key: Any) -> Optional[RepoEntry]:
        with self._lock:
            return self._table.get(key)

    def set_usage_limit(self, key: Any, limit: int) -> None:
        """Producer declares consumer count; reclaim if consumers already
        came through (reference ``data_repo_entry_addto_usage_limit``)."""
        with self._lock:
            e = self._table.get(key)
            if e is None:
                e = self._table[key] = RepoEntry(key, self.nb_flows)
            e.usage_limit += limit
            if e.usage_limit > 0 and e.usage_count >= e.usage_limit:
                del self._table[key]

    def consume(self, key: Any) -> Optional[RepoEntry]:
        """A consumer takes its input; entry reclaimed when all have."""
        with self._lock:
            e = self._table.get(key)
            if e is None:
                return None
            e.usage_count += 1
            if e.usage_limit > 0 and e.usage_count >= e.usage_limit:
                del self._table[key]
            return e

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)
