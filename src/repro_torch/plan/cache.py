"""Bounded LRU plan cache — the in-memory tier of the serving cache
hierarchy (request -> plan cache -> wisdom store -> tuner).

Counterpart of ``repro.plan.cache``.  The wisdom store answers "which
execution schedule is best for this problem" without re-tuning, but
consulting it still costs a file read, a partition, and building the
plan's dispatch groups with their row-index tensors on the device.  A
serving loop handling a mixed stream of sizes cannot pay that per request,
so ``PlanCache`` keeps the *built* ``PfftPlan`` objects hot in memory
behind a bounded LRU: a hit is a dict lookup and returns the very same
plan object — zero re-tune, zero re-build.

Counters make the cache auditable from service stats:

* ``hits``/``misses``/``evictions`` — the usual LRU accounting; the
  bound keeps a long-tailed size mix from pinning one executable per
  size ever seen.
* ``retunes`` — how many *built* plans actually ran the tuner
  (``tuning["source"]`` of ``"estimate"``/``"measure"``) rather than
  being served from wisdom or an explicit config.  A warm serve run
  against a warm wisdom store must report zero: that is the acceptance
  counter the serving benchmark asserts.

Builds run under the cache lock, so two callers racing the same cold key
tune once, not twice — the same single-flight property the wisdom file
lock provides across processes, applied in-process.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

__all__ = ["CacheStats", "PlanCache"]

# Tuning sources that mean the build callable actually ran the tuner (device
# work for "measure", a cost-model sweep for "estimate") instead of
# being served a stored or explicit plan.
_TUNED_SOURCES = ("estimate", "measure")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    retunes: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


class PlanCache:
    """Bounded LRU mapping plan keys to built plans (see module docstring).

    ``get`` is the single entry point: a hit refreshes recency and
    returns the cached plan; a miss calls ``build()`` (under the lock —
    single-flight per key), records whether the built plan re-tuned, and
    evicts the least-recently-used entry past ``maxsize``.
    """

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def get(self, key: Hashable, build: Callable[[], Any]
            ) -> tuple[Any, bool]:
        """(plan, hit) for ``key``, building and inserting on a miss."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return self._entries[key], True
            plan = build()
            self.stats.misses += 1
            if getattr(plan, "tuning", None) and \
                    plan.tuning.get("source") in _TUNED_SOURCES:
                self.stats.retunes += 1
            self._entries[key] = plan
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            return plan, False

    def peek(self, key: Hashable) -> Any | None:
        """The cached plan without touching recency or counters (the
        admission pricer peeks so pricing never distorts the LRU)."""
        with self._lock:
            return self._entries.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list[Hashable]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def reset_stats(self) -> None:
        """Zero the counters, keeping the entries — a warm second run
        starts its audit from a clean slate."""
        with self._lock:
            self.stats = CacheStats()

    def stats_dict(self) -> dict[str, int]:
        with self._lock:
            d = self.stats.as_dict()
            d["size"] = len(self._entries)
            d["maxsize"] = self.maxsize
            return d
