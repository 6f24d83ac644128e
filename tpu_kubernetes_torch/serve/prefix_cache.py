"""Bounded LRU of KV-cache prompt prefixes (the serve-side prefix reuse
store behind ``SERVE_PREFIX_CACHE_MB``; the port's own copy of
``tpu_kubernetes/serve/prefix_cache.py``).

A request whose prompt shares a token-id prefix with an earlier request
can skip recomputing that prefix's K/V: causality makes cache slot i a
pure function of tokens <= i, so ANY stored segment is reusable up to the
longest common prefix with the new prompt, even a *partial* match against
a longer stored entry (the first q slots of a p-slot segment are exactly
what a fresh prefill of those q tokens computes).

This module is a plain container: it stores opaque tensors (shaped
(layers, 1, kv_heads, n_tokens, head_dim) by the server's convention) and
never touches a device. Every slice and copy happens at the call site,
which stores clones: a slice of a captured program's cache is a view that
the program's next replay overwrites.

Sizing is byte-accurate (``numel() * element_size()`` summed over the
stored tensors); eviction is least-recently-USED (lookup hits and covered
inserts refresh recency). Subsumption keeps the store minimal: inserting
ids already covered by a stored entry only refreshes that entry;
inserting an extension REPLACES the shorter entry. Thread-safe: handler
threads and the batch dispatcher share one store."""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable


def _arrays_nbytes(arrays: dict[str, Any]) -> int:
    return sum(
        int(a.numel()) * int(a.element_size())
        for a in arrays.values() if a is not None
    )


def _common_prefix_len(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclass
class PrefixEntry:
    """One cached prefix: ``arrays`` hold exactly ``len(ids)`` filled
    positions (the server trims pad garbage before inserting)."""

    ids: tuple[int, ...]
    arrays: dict[str, Any]
    nbytes: int = field(init=False)

    def __post_init__(self):
        self.nbytes = _arrays_nbytes(self.arrays)


@dataclass
class PagedPrefixEntry:
    """One cached prefix under the PAGED engine: instead of copied
    tensors, ``pages`` are the device pool page ids holding the prefix's
    K/V (whole pages only: ``len(ids)`` is a page_size multiple). The
    store OWNS these pages (``PagePool.pin``): a warm hit references them
    read-only from the new slot's table, and copy-on-write is structural
    (appends land past the prompt width in fresh pages, so a shared page
    is never written after insert). ``nbytes`` is the device bytes the
    pages occupy (page_bytes x len(pages)), passed in because this module
    never sees the pool. Eviction must reach the pool: the cache's
    ``on_evict`` callback is how the engine unpins (and wipes) a dropped
    entry's pages."""

    ids: tuple[int, ...]
    pages: tuple[int, ...]
    nbytes: int


class PrefixCache:
    """Longest-prefix-match LRU over :class:`PrefixEntry`, capped at
    ``max_bytes``. ``sig`` records the model/config signature the
    segments were computed under (one store never serves two models; the
    signature makes that checkable in ``stats()``). ``on_bytes`` (when
    given) observes the total after every operation."""

    def __init__(self, max_bytes: int, sig: tuple = (),
                 on_bytes: Callable[[int], None] | None = None,
                 on_evict: Callable[[Any], None] | None = None):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.sig = tuple(sig)
        self._on_bytes = on_bytes
        # on_evict(entry) fires for every entry the store DROPS (LRU
        # eviction and extension replacement both) after the lock is
        # released: the paged engine's handler takes its own lock to
        # unpin and wipe the entry's pool pages, and calling back under
        # ours would order the two locks both ways
        self._on_evict = on_evict
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    # -- internals (caller holds the lock) ---------------------------------

    def _notify(self) -> None:
        if self._on_bytes is not None:
            self._on_bytes(self._bytes)

    def _evict_to_cap(self) -> list:
        dropped = []
        while self._bytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)   # least recent
            self._bytes -= old.nbytes
            dropped.append(old)
        return dropped

    def _notify_evicted(self, dropped: list) -> None:
        """Caller must NOT hold the lock (see on_evict above)."""
        if self._on_evict is not None:
            for e in dropped:
                self._on_evict(e)

    # -- API ---------------------------------------------------------------

    def lookup(self, ids: list[int]) -> tuple[int, PrefixEntry | None]:
        """Longest common prefix across the store → (match length, the
        matching entry). A hit refreshes the entry's recency. (0, None)
        when nothing shares even one token."""
        key = tuple(ids)
        with self._lock:
            best_q, best = 0, None
            for entry in self._entries.values():
                q = _common_prefix_len(entry.ids, key)
                if q > best_q:
                    best_q, best = q, entry
            if best is not None:
                self._entries.move_to_end(best.ids)
            return best_q, best

    def insert(self, ids: list[int], arrays: dict[str, Any]) -> bool:
        """Store a segment for ``ids`` (tensors trimmed to len(ids)
        positions). Returns True when stored; False when skipped: ids
        already covered by a stored entry (recency refreshed instead) or
        the segment alone exceeds the cap. Inserting an EXTENSION of a
        stored prefix replaces the shorter entry; eviction then drops
        least-recently-used entries until the total fits the cap."""
        return self._insert_entry(PrefixEntry(ids=tuple(ids),
                                              arrays=arrays))

    def insert_paged(self, ids: list[int], pages: list[int],
                     nbytes: int) -> bool:
        """Store a PAGED prefix (device pool page ids, see
        :class:`PagedPrefixEntry`). Same subsumption and eviction contract
        as :meth:`insert`; the caller pins the pages only on True (a
        skipped insert must not strand a pin)."""
        return self._insert_entry(PagedPrefixEntry(
            ids=tuple(ids), pages=tuple(pages), nbytes=int(nbytes),
        ))

    def _insert_entry(self, entry: Any) -> bool:
        key = entry.ids
        if not key:
            return False
        if entry.nbytes > self.max_bytes:
            return False
        dropped: list = []
        with self._lock:
            for have in list(self._entries.values()):
                q = _common_prefix_len(have.ids, key)
                if q == len(key) and len(have.ids) >= len(key):
                    # covered: the stored entry serves this prefix and
                    # more; storing again would only duplicate bytes
                    self._entries.move_to_end(have.ids)
                    self._notify()
                    return False
                if q == len(have.ids) and len(key) > len(have.ids):
                    # extension: the new segment subsumes the stored one
                    del self._entries[have.ids]
                    self._bytes -= have.nbytes
                    dropped.append(have)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            dropped += self._evict_to_cap()
            self._notify()
        self._notify_evicted(dropped)
        return True

    def clear(self, notify: bool = False) -> int:
        """Drop every entry; returns how many. The paged engine's
        cold-reset path: a reinitialized page pool invalidates stored page
        ids wholesale, so the default drops WITHOUT on_evict (the pages no
        longer exist to unpin); ``notify=True`` routes the drops through
        on_evict for an orderly teardown instead."""
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
            self._notify()
        if notify:
            self._notify_evicted(dropped)
        return len(dropped)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """The /healthz mirror: entry count, bytes vs cap, signature."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "sig": list(self.sig),
            }
