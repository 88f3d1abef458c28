"""Process-wide cache of built callables, keyed by semantic identity — the
PyTorch port's copy of ``repro.sim.execache``.

The key is the evaluator family — :func:`graph_key` (operator tuple + edge
list, so separately-constructed but identical graphs collide on purpose),
the frozen :class:`~repro_torch.core.costmodel.CostConfig` and the torch
``device`` (in place of the reference's pallas flags) — plus the entry
point kind and whatever static state it closes over (the region layout of
a structured family).  PyTorch runs eagerly, so what is cached is not a
compiled executable but the built per-layout state (device index tensors,
the region one-hot) and the evaluator instances behind
``BatchedEvaluator.shared()``.

Hit/miss/evict counters publish into ``repro_torch.obs`` (label ``kind=``
the key's leading tag) when the registry is enabled;
:meth:`ExecutableCache.stats` reports them unconditionally for the serving
layer's accounting.  :func:`fresh_cache` scopes an isolated cache for tests.
"""

from __future__ import annotations

import collections
import contextlib
import threading

from repro_torch import obs

__all__ = ["ExecutableCache", "executable_cache", "set_executable_cache",
           "fresh_cache", "graph_key"]


def graph_key(graph) -> tuple:
    """Content identity of an :class:`~repro.core.graph.OpGraph`: the
    operator tuple (frozen dataclasses) plus the edge list.  Two graphs
    built independently from the same spec hash equal — that equality is
    what lets separate consumers share one evaluator."""
    return (tuple(graph.operators), tuple(graph.edges))


class ExecutableCache:
    """Thread-safe LRU of built values.

    ``get_or_build(key, builder)`` returns the cached value for ``key`` or
    invokes ``builder()`` and caches it.  Keys are arbitrary hashable
    tuples whose first element names the entry-point kind (used as the obs
    label).
    """

    def __init__(self, capacity: int = 512, name: str = "executables"):
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _count(self, event: str, kind: str) -> None:
        reg = obs.registry()
        if reg.enabled:
            reg.counter(f"cache.{self.name}.{event}", kind=kind).add(1)

    def get_or_build(self, key: tuple, builder):
        kind = str(key[0]) if isinstance(key, tuple) and key else "?"
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self._count("hits", kind)
                return fn
            self.misses += 1
            self._count("misses", kind)
            fn = builder()
            self._entries[key] = fn
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                self._count("evictions", kind)
            return fn

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        """JSON-able counters (always collected, registry or not)."""
        with self._lock:
            lookups = self.hits + self.misses
            return {"name": self.name, "size": len(self._entries),
                    "capacity": self.capacity, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": self.hits / lookups if lookups else None}


_cache = ExecutableCache()


def executable_cache() -> ExecutableCache:
    """The process-wide default cache every evaluator builds through."""
    return _cache


def set_executable_cache(cache: ExecutableCache) -> ExecutableCache:
    """Swap the process-wide cache (returns the previous one)."""
    global _cache
    prev, _cache = _cache, cache
    return prev


@contextlib.contextmanager
def fresh_cache(capacity: int = 512, name: str = "executables"):
    """Scope an isolated ExecutableCache as the process default — restores
    the previous cache on exit (test isolation)."""
    prev = set_executable_cache(ExecutableCache(capacity, name))
    try:
        yield executable_cache()
    finally:
        set_executable_cache(prev)
