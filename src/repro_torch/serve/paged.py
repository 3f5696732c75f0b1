"""Host-side page allocator for the paged KV cache (DESIGN.md §10).

The device side is dumb on purpose — pools are flat ``[N, page, Hkv, dh]``
buffers and the model just scatters/gathers through a ``[slots, P]`` table —
so all policy lives here, in plain numpy/python that runs between ticks:

* **free list** — retired pages go back verbatim; stale contents are safe
  because every read is masked by the owner's sequence length.
* **refcounts** — a page is held by each slot whose table row maps it, plus
  one reference while the prefix registry caches it.  A slot may write a
  page only while it is the sole holder.
* **prefix registry** — chained hashes of page-aligned prompt blocks map to
  resident pages, so a request admitted with a known system-prompt prefix
  maps those pages read-only instead of recomputing prefill for them.
  Registry-only pages (refcount 1) are the eviction victims, oldest first.
* **copy-on-write** — before a step writes positions ``[start, end)``,
  :meth:`PageAllocator.ensure` forks any shared page in that range: a fresh
  page is allocated, the device copies the contents (the batcher applies the
  returned ``(src, dst)`` pairs), and the table row is repointed.
* **reservations** — admission reserves every page the request can touch
  (``ceil(min(prompt + max_new, max_len) / page)``, minus reused prefix
  pages, plus one for the full-reuse CoW fork), so an admitted request can
  never deadlock mid-decode on an exhausted pool.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch.obs import metrics

__all__ = ["AdmitPlan", "PageAllocator"]


@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """What admission decided for one request."""

    reuse_len: int  # prompt positions covered by reused prefix pages
    start: int  # prefill continuation start (min(reuse_len, L-1))
    reused_pages: tuple  # page ids mapped read-only from the registry


class PageAllocator:
    def __init__(
        self,
        *,
        slots: int,
        page_size: int,
        max_pages: int,
        num_pages: int,
        prefix_cache: bool = True,
    ):
        if num_pages < max_pages:
            raise ValueError(
                f"pool of {num_pages} pages cannot hold one full sequence "
                f"({max_pages} pages)"
            )
        self.slots = slots
        self.page = page_size
        self.max_pages = max_pages
        self.num_pages = num_pages
        self.prefix_cache = prefix_cache
        self.table = np.full((slots, max_pages), -1, np.int32)
        self.refcount = np.zeros(num_pages, np.int32)
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self._registry: dict[int, int] = {}  # chained prefix hash -> page id
        self._page_hash: dict[int, int] = {}  # page id -> its registry hash
        self._lru: OrderedDict[int, None] = OrderedDict()  # hashes, oldest first
        self._reserved = np.zeros(slots, np.int64)
        # telemetry — the local ints stay (per-allocator reports); the
        # registry children mirror them process-wide (DESIGN.md §14)
        self.prefix_hit_pages = 0
        self.cow_forks = 0
        self.evictions = 0
        self.allocs = 0
        self.draft_truncations = 0
        self.pages_reclaimed = 0
        _m = metrics.default()
        self._m_prefix_hits = _m.counter("kv.prefix_hit_pages")
        self._m_cow = _m.counter("kv.cow_forks")
        self._m_evict = _m.counter("kv.evictions")
        self._m_alloc = _m.counter("kv.allocs")
        self._m_trunc = _m.counter("kv.draft_truncations")
        self._m_reclaim = _m.counter("kv.pages_reclaimed")

    # -- capacity --------------------------------------------------------

    def _evictable(self) -> int:
        return sum(1 for h in self._lru if self.refcount[self._registry[h]] == 1)

    def available(self) -> int:
        """Pages obtainable right now: free list + evictable registry pages."""
        return len(self._free) + self._evictable()

    def resident_pages(self) -> int:
        """Pages holding live K/V (slot-held or registry-cached)."""
        return self.num_pages - len(self._free)

    def pages_for(self, prompt_len: int, max_new: int, max_len: int) -> int:
        total = min(prompt_len + max_new, max_len)
        return -(-total // self.page)

    # -- page supply -----------------------------------------------------

    def _alloc(self) -> int:
        if self._free:
            self.allocs += 1
            self._m_alloc.inc()
            return self._free.pop()
        for h in list(self._lru):  # oldest first
            pid = self._registry[h]
            if self.refcount[pid] == 1:  # held only by the registry
                del self._registry[h]
                del self._page_hash[pid]
                del self._lru[h]
                self.refcount[pid] = 0
                self.evictions += 1
                self.allocs += 1
                self._m_evict.inc()
                self._m_alloc.inc()
                return pid
        raise RuntimeError(
            "page pool exhausted despite reservations (allocator bug)"
        )

    def _decref(self, pid: int) -> None:
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            # Dirty page straight back to the free list — no clearing; reads
            # are masked by the next owner's sequence length.
            self._free.append(pid)

    # -- prefix hashing --------------------------------------------------

    def _block_hashes(self, prompt) -> list[int]:
        """Chained hash per FULL prompt page (page j depends on 0..j)."""
        hashes = []
        h = 0
        for j in range(len(prompt) // self.page):
            block = tuple(int(tok) for tok in prompt[j * self.page:(j + 1) * self.page])
            h = hash((h, block))
            hashes.append(h)
        return hashes

    # -- lifecycle -------------------------------------------------------

    def admit(self, slot: int, prompt, max_new: int, max_len: int):
        """Map reusable prefix pages and reserve the rest.

        Returns an :class:`AdmitPlan`, or None when the pool cannot cover the
        request right now (caller keeps it queued).  Only FULL prompt pages
        are ever shared — decode never writes them (the first decode write
        lands at position ``len(prompt)``), except the full-reuse case where
        the last prompt token is re-run to produce the first output; that
        write CoW-forks, which the reservation accounts for.
        """
        assert (self.table[slot] == -1).all(), f"slot {slot} not released"
        prompt_len = len(prompt)
        total = self.pages_for(prompt_len, max_new, max_len)
        reused: list[int] = []
        if self.prefix_cache:
            for h in self._block_hashes(prompt)[:total]:
                pid = self._registry.get(h)
                if pid is None:
                    break
                reused.append(pid)
                self._lru.move_to_end(h)
        reuse_len = len(reused) * self.page
        need = total - len(reused)
        if reuse_len >= prompt_len:
            need += 1  # the last-token re-run CoW-forks one shared page
        for j, pid in enumerate(reused):
            self.table[slot, j] = pid
            self.refcount[pid] += 1
        if self.available() - int(self._reserved.sum()) < need:
            for j, pid in enumerate(reused):  # roll back
                self.table[slot, j] = -1
                self.refcount[pid] -= 1
            return None
        self._reserved[slot] = need
        self.prefix_hit_pages += len(reused)
        self._m_prefix_hits.inc(len(reused))
        return AdmitPlan(
            reuse_len=reuse_len,
            start=min(reuse_len, prompt_len - 1),
            reused_pages=tuple(reused),
        )

    def ensure(self, slot: int, start: int, end: int) -> list[tuple[int, int]]:
        """Make positions ``[start, end)`` of ``slot`` privately writable.

        Allocates unmapped pages and CoW-forks shared ones; returns the
        ``(src_page, dst_page)`` copies the caller must apply to the device
        pools before running the step.
        """
        forks: list[tuple[int, int]] = []
        for j in range(start // self.page, -(-end // self.page)):
            pid = int(self.table[slot, j])
            if pid < 0:
                npid = self._alloc()
                self.refcount[npid] = 1
                self.table[slot, j] = npid
            elif self.refcount[pid] > 1:
                npid = self._alloc()
                self.refcount[npid] = 1
                self._decref(pid)
                self.table[slot, j] = npid
                forks.append((pid, npid))
                self.cow_forks += 1
                self._m_cow.inc()
            else:
                continue
            if self._reserved[slot] > 0:
                self._reserved[slot] -= 1
        return forks

    def register_prefix(self, slot: int, prompt) -> None:
        """Publish this slot's full prompt pages to the prefix registry."""
        if not self.prefix_cache:
            return
        for j, h in enumerate(self._block_hashes(prompt)):
            if j >= self.max_pages:
                break
            pid = int(self.table[slot, j])
            if pid < 0:
                break
            if h in self._registry:
                self._lru.move_to_end(h)
                continue
            if pid in self._page_hash:
                continue  # page already published under another hash
            self._registry[h] = pid
            self._page_hash[pid] = h
            self.refcount[pid] += 1
            self._lru[h] = None

    def release(self, slot: int) -> None:
        """Retire a slot: drop its page references and reservation.  Pages the
        registry still caches stay resident for future prefix hits."""
        for j in range(self.max_pages):
            pid = int(self.table[slot, j])
            if pid >= 0:
                self._decref(pid)
                self.table[slot, j] = -1
        self._reserved[slot] = 0

    def truncate(self, slot: int, new_len: int) -> int:
        """Shrink ``slot`` to ``new_len`` positions, freeing orphaned pages
        IMMEDIATELY (DESIGN.md §11).

        Speculative rejection is just this truncation: pages are append-only
        per owner, so a rejected draft tail leaves whole now-unused pages
        past ``ceil(new_len / page)`` — they go straight back to the free
        list (not through LRU; they hold garbage K/V nobody can ever read,
        masked by the owner's length).  Each unmapped page restores one unit
        of the slot's admission reservation: the slot will allocate that
        page again as decode advances, and the reservation invariant (an
        admitted request never deadlocks on an exhausted pool) must survive
        truncation.  Returns the number of pages returned to the free list.
        """
        freed = 0
        for j in range(-(-new_len // self.page), self.max_pages):
            pid = int(self.table[slot, j])
            if pid < 0:
                continue
            before = len(self._free)
            self._decref(pid)
            self.table[slot, j] = -1
            self._reserved[slot] += 1
            if len(self._free) > before:
                freed += 1
        self.draft_truncations += 1
        self.pages_reclaimed += freed
        self._m_trunc.inc()
        self._m_reclaim.inc(freed)
        return freed

    # -- state round-trip (drain checkpoints, DESIGN.md §12) -------------

    def state_dict(self) -> dict:
        """JSON-serializable allocator state.

        A drained engine's checkpoint must carry the page table, refcounts
        and the prefix registry alongside the KV pools: a restored server
        that kept the pools but lost the registry would re-prefill every
        shared prefix (correct but slow), and one that lost refcounts would
        free registry-held pages (corrupt).  Chained block hashes are Python
        ints over tuples of ints — deterministic across processes (only str
        hashing is seed-randomized), so the registry round-trips as plain
        JSON.
        """
        return {
            "table": self.table.tolist(),
            "refcount": self.refcount.tolist(),
            "free": list(self._free),
            "registry": [[int(h), int(pid)] for h, pid in self._registry.items()],
            "lru": [int(h) for h in self._lru],
            "reserved": self._reserved.tolist(),
        }

    def load_state_dict(self, state: dict) -> None:
        table = np.asarray(state["table"], np.int32)
        if table.shape != self.table.shape:
            raise ValueError(
                f"page table shape {table.shape} != {self.table.shape}"
            )
        self.table = table
        self.refcount = np.asarray(state["refcount"], np.int32)
        self._free = [int(p) for p in state["free"]]
        self._registry = {int(h): int(pid) for h, pid in state["registry"]}
        self._page_hash = {pid: h for h, pid in self._registry.items()}
        self._lru = OrderedDict((int(h), None) for h in state["lru"])
        self._reserved = np.asarray(state["reserved"], np.int64)
        self.check_leaks()

    # -- invariants ------------------------------------------------------

    def check_leaks(self) -> None:
        """Assert the pool is exactly partitioned: every page is either on
        the free list (refcount 0, unmapped) or resident with a refcount
        equal to its holder count (slot table rows + registry entry).  The
        speculative tick loop calls this in tests after EVERY tick — a
        truncation that forgot a decref, or freed a page a table row still
        maps, fails here immediately."""
        held = np.zeros(self.num_pages, np.int64)
        for s in range(self.slots):
            for j in range(self.max_pages):
                pid = int(self.table[s, j])
                if pid >= 0:
                    held[pid] += 1
        for pid in self._page_hash:
            held[pid] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages on the free list"
        for pid in range(self.num_pages):
            if pid in free:
                assert held[pid] == 0 and self.refcount[pid] == 0, (
                    f"page {pid} on the free list but held/referenced"
                )
            else:
                assert held[pid] == int(self.refcount[pid]) and held[pid] > 0, (
                    f"page {pid}: refcount {int(self.refcount[pid])} != "
                    f"{int(held[pid])} holders"
                )
        assert len(self._free) + self.resident_pages() == self.num_pages
