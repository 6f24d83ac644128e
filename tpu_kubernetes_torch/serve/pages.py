"""Host-side KV page accounting for the paged slot engine
(``SERVE_KV_POOL_MB`` > 0): the free list, per-page reference counts and
the pins of a prefix store over the device pool that
``models/decode.py``'s :class:`PagedKVCache` provides (the port's own copy
of ``tpu_kubernetes/serve/pages.py``).

Allocation is host-authoritative: programs never touch the free list
(static shapes: the engine tops every live row's page table up before
each segment), so this module is plain Python and single-threaded (the
scheduler thread owns it; other threads only read :meth:`PagePool.stats`).

Page states are disjoint and conserved; every usable page is exactly one
of:

* **free**: on the free list, wiped back to zeros on the device;
* **live**: referenced by at least one resident slot's table and not
  owned by a prefix store;
* **pinned**: owned by a prefix store (a shared read-only prompt prefix),
  whether or not slots also reference it. A page may belong to several
  store entries at once (a warm admission's prompt starts with the pages
  it reused, and storing that prompt pins them again), so pins are
  counted: the page stays pinned until its last owner unpins it. (The
  reference keeps a set, so evicting one of two entries that share a page
  would free and wipe a page the other still serves.)

``free + live + pinned == total`` is the no-leak invariant; :meth:`stats`
recomputes the partition from the ground truth at every call, so a page
dropped on the floor breaks the sum instead of hiding. Physical page 0,
the programs' write sink for retired rows, is outside the pool and its
arithmetic.

A page goes back to the free list only when its count is zero AND no
store owns it: a retiring slot drops its references (shared prefix pages
stay for the next warm hit), a store eviction unpins (resident readers
keep the page until they retire). :meth:`PagePool.allocate` fires the
``serve.page_alloc`` fault-injection site (``obs/faults.py``).
"""

from __future__ import annotations

from tpu_kubernetes_torch.obs.faults import FAULTS


class PagePool:
    """Free list and reference counts for ``total`` usable device pages,
    numbered 1..total (page 0 is the device's write sink and never leaves
    this constructor). FIFO reuse keeps recycling across the whole pool,
    which also makes leak tests deterministic."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"page pool needs >= 1 page, got {total}")
        self.total = int(total)
        self._free: list[int] = list(range(1, self.total + 1))
        self._refs: dict[int, int] = {}
        # page → the store entries that own it
        self._pinned: dict[int, int] = {}
        self.stalls = 0          # allocation requests the pool rejected

    # -- slot lifecycle -----------------------------------------------------

    def allocate(self, n: int) -> list[int] | None:
        """Take ``n`` pages off the free list at count 1, or None when the
        pool cannot grant them all (the caller stalls admission or
        preempts: a partial grant would leak on the error path). Fires the
        ``serve.page_alloc`` chaos site."""
        FAULTS.fire("serve.page_alloc")
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            self.stalls += 1
            return None
        got, self._free = self._free[:n], self._free[n:]
        for p in got:
            self._refs[p] = 1
        return got

    def ref(self, pages: list[int]) -> None:
        """A slot starts sharing already-resident pages."""
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1

    def release(self, pages: list[int]) -> list[int]:
        """Drop one reference a page → the pages that became FREE (count
        0, not pinned): the caller wipes exactly these on the device
        before they are reused."""
        freed = []
        for p in pages:
            left = self._refs.get(p, 0) - 1
            if left < 0:
                raise RuntimeError(f"page {p} released below zero refs")
            if left:
                self._refs[p] = left
                continue
            self._refs.pop(p, None)
            if p not in self._pinned:
                self._free.append(p)
                freed.append(p)
        return freed

    # -- prefix-store lifecycle ---------------------------------------------

    def pin(self, pages: list[int]) -> None:
        """A prefix-store entry takes ownership of resident pages (they must
        be referenced or pinned now: pinning a free page would resurrect
        wiped bytes); each entry's pin counts."""
        for p in pages:
            if p not in self._refs and p not in self._pinned:
                raise RuntimeError(f"cannot pin non-resident page {p}")
        for p in pages:
            self._pinned[p] = self._pinned.get(p, 0) + 1

    def unpin(self, pages: list[int]) -> list[int]:
        """An entry's eviction: give its ownership up → the pages now free
        (no other entry owns them and no slot reads them), for the caller
        to wipe."""
        freed = []
        for p in pages:
            owners = self._pinned.get(p, 0) - 1
            if owners < 0:
                raise RuntimeError(f"page {p} unpinned but not pinned")
            if owners:
                self._pinned[p] = owners
                continue
            del self._pinned[p]
            if self._refs.get(p, 0) == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    # -- observability ------------------------------------------------------

    def free_count(self) -> int:
        return len(self._free)

    def stats(self) -> dict:
        """The disjoint free / live / pinned partition, recomputed from the
        ground truth, so ``free + live + pinned == total`` failing IS a
        leak, not a bookkeeping echo."""
        pinned = len(self._pinned)
        live = len([p for p in self._refs if p not in self._pinned])
        return {
            "total": self.total,
            "free": len(self._free),
            "live": live,
            "pinned": pinned,
            "stalls": self.stalls,
        }
