"""The engine's paged KV pool with shared-prefix copy-on-write — the port's
``repro/serve/pool.py``.

One set of physical pages per engine (``[n_pages, Hkv, page, D]`` K and V
tensors per attention layer), a page table per request mapping its logical
page index to a physical page, and refcounted alloc and free. A request
holds only the pages it has written, so more prefills fit in flight than
whole-cache reservations allow.

**Shared prefixes.** At prefill completion a request registers its prompt
(and every full-page prefix of it) in a weak registry of ``(page id,
generation)`` snapshots; a later request with the same prefix maps those
pages (refcount + 1) and prefills only its tail. Any write into a page
whose refcount exceeds one first copies the page (copy-on-write). Entries
are checked at lookup, so the registry never pins a page and the refcounts
drain to zero with the requests (:meth:`PagedKVPool.check_balanced`).

**Admission** reserves each resident request's worst-case remaining pages
plus ``RESERVE_SLACK`` pages of copy-on-write headroom: :meth:`can_admit`
admits only when the free list covers them all, so an allocation in flight
cannot fail.

The host bookkeeping is the reference's. The device side differs: the
reference threads its page arrays through jitted programs functionally,
while here the page tensors are made once on the engine's device and never
replaced — a captured decode step holds their addresses — so a
copy-on-write split copies pages in place (:meth:`_apply_copies`) and
:meth:`device_table` fills the caller's fixed table tensor.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def supports_prefix_sharing(cfg: ArchConfig) -> bool:
    """A prefix can be reused only where every layer's state for positions
    [0, hit) lives in pool pages: attention layers (windowed ones too —
    their paged cache is linear). Recurrent and SSD layers carry state a
    hit would skip computing, so hybrids prefill every token."""
    return all(spec.mixer in ("attn", "local_attn") for spec in cfg.layers())


@dataclasses.dataclass(frozen=True)
class _PrefixEntry:
    """Weak snapshot of the pages holding one registered token prefix."""
    length: int
    pages: Tuple[int, ...]
    gens: Tuple[int, ...]


class PagedKVPool:
    """Host page bookkeeping and the device page tensors of one engine."""

    # Copy-on-write headroom reserved per request: at most one split as a
    # prefix recipient (its shared partial tail page) plus one as a donor
    # (its registered tail page, split when its own decode write lands in a
    # now-shared page).
    RESERVE_SLACK = 2

    # Weak prefix entries kept before the oldest is evicted.
    MAX_PREFIX_ENTRIES = 512

    def __init__(self, cfg: ArchConfig, *, n_pages: int, page: int,
                 max_len: int, dtype, prefix_sharing: bool = True,
                 metrics=None, trace=None, device=None):
        from repro_torch.models import api

        if n_pages <= 0 or page <= 0:
            raise ValueError(f"bad pool geometry: {n_pages} pages of {page}")
        self.cfg = cfg
        self.page = int(page)
        self.n_pages = int(n_pages)
        self.max_len = int(max_len)
        # Every request's table has n_pt entries, however many are mapped
        # (unmapped ones point at page 0; positions mask them).
        self.n_pt = cdiv(max_len, page)
        self.device = resolve_device(device)
        self.arrays = api.make_paged_pool(cfg, n_pages, page, dtype,
                                          device=self.device)
        self.prefix_sharing = bool(prefix_sharing) and \
            supports_prefix_sharing(cfg)
        self.metrics = metrics
        self._trace = trace

        self.refcount: List[int] = [0] * self.n_pages
        # Bumped when a page returns to the free list, so a stale prefix
        # entry pointing at a recycled page id fails its generation check.
        self.generation: List[int] = [0] * self.n_pages
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}
        self._need: Dict[int, int] = {}
        self._allocs: Dict[int, int] = {}
        self._prefix: "OrderedDict[Tuple[int, ...], _PrefixEntry]" = \
            OrderedDict()

    # -- occupancy ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return cdiv(max(int(total_tokens), 1), self.page)

    def _outstanding(self) -> int:
        """Worst-case future page demand of every resident request."""
        return sum(
            max(0, self._need[r] + self.RESERVE_SLACK - self._allocs[r])
            for r in self._need)

    # -- request lifecycle -------------------------------------------------
    def can_admit(self, total_tokens: int) -> bool:
        """True when admitting a request that will write ``total_tokens``
        positions can never exhaust the pool mid-flight."""
        need = self.pages_needed(total_tokens) + self.RESERVE_SLACK
        return need + self._outstanding() <= self.free_pages

    def register_request(self, rid: int, total_tokens: int) -> None:
        if rid in self.tables:
            raise ValueError(f"request {rid} already registered")
        self.tables[rid] = []
        self._need[rid] = self.pages_needed(total_tokens)
        self._allocs[rid] = 0

    def release(self, rid: int, missing_ok: bool = False) -> int:
        """Drop every page reference ``rid`` holds; pages whose refcount
        reaches zero return to the free list (generation bumped). Raises
        ``KeyError`` on an unknown or already released rid — a double
        release is a lifecycle bug — unless ``missing_ok``. Returns the
        pages freed."""
        if missing_ok and rid not in self.tables:
            return 0
        table = self.tables.pop(rid)
        del self._need[rid], self._allocs[rid]
        freed = 0
        for pid in table:
            if self.refcount[pid] <= 0:
                raise RuntimeError(
                    f"double free: page {pid} (rid {rid}) has refcount "
                    f"{self.refcount[pid]}")
            self.refcount[pid] -= 1
            if self.refcount[pid] == 0:
                self.generation[pid] += 1
                self._free.append(pid)
                freed += 1
        if self.metrics is not None:
            self.metrics.record_page_free(freed)
            self.metrics.record_pool(self.used_pages, self.n_pages)
        if self._trace is not None:
            self._trace.page_free(rid, freed, self.used_pages, self.n_pages)
        return freed

    # -- page allocation / copy-on-write -----------------------------------
    def _alloc(self, rid: int) -> int:
        if not self._free:
            raise RuntimeError(
                "paged KV pool exhausted — reservation accounting should "
                "make this unreachable (can_admit gate bypassed?)")
        pid = self._free.pop()
        assert self.refcount[pid] == 0, (pid, self.refcount[pid])
        self.refcount[pid] = 1
        self._allocs[rid] += 1
        if self.metrics is not None:
            self.metrics.record_page_alloc()
        return pid

    def prepare_span(self, rid: int, start: int, length: int) -> None:
        """Make positions ``[start, start+length)`` writable by ``rid``:
        allocate pages for unmapped logical indices and split mapped pages
        whose refcount exceeds one (the copies land in the page tensors
        here). Runs before every cache write, chunk and decode step alike;
        writes append, so the span starts at or before the table's end."""
        if length <= 0:
            return
        table = self.tables[rid]
        first = start // self.page
        last = (start + length - 1) // self.page
        if first > len(table):
            raise ValueError(
                f"non-contiguous write: rid {rid} start {start} but only "
                f"{len(table)} pages mapped")
        copies: List[Tuple[int, int]] = []
        fresh = 0
        for idx in range(first, last + 1):
            if idx < len(table):
                pid = table[idx]
                if self.refcount[pid] > 1:
                    dst = self._alloc(rid)
                    self.refcount[pid] -= 1
                    table[idx] = dst
                    copies.append((pid, dst))
                    if self.metrics is not None:
                        self.metrics.record_cow_split()
                    if self._trace is not None:
                        self._trace.cow_split(rid, pid, dst)
            else:
                table.append(self._alloc(rid))
                fresh += 1
        if self.metrics is not None and (fresh or copies):
            self.metrics.record_pool(self.used_pages, self.n_pages)
        if self._trace is not None and fresh:
            self._trace.page_alloc(rid, fresh, self.used_pages, self.n_pages)
        self._apply_copies(copies)

    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Copy page contents src -> dst in every layer's K and V, in place
        (the page tensors keep their addresses)."""
        if not copies:
            return
        src = torch.tensor([s for s, _ in copies], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in copies], dtype=torch.long,
                           device=self.device)
        for leaf in self.arrays:
            if leaf is None:
                continue
            for pages in leaf.values():
                pages.index_copy_(0, dst, pages.index_select(0, src))

    # -- device views ------------------------------------------------------
    def device_table(self, rid: int, out: torch.Tensor) -> torch.Tensor:
        """Copy the request's table, padded to ``n_pt`` entries (unmapped
        ones point at page 0, which positions mask), into ``out``: a fixed
        ``int32 [n_pt]`` tensor of the caller's, which a captured step
        reads. Returns ``out``."""
        table = self.tables[rid]
        out.copy_(torch.tensor(table + [0] * (self.n_pt - len(table)),
                               dtype=torch.int32))
        return out

    def new_table(self) -> torch.Tensor:
        """A table tensor for :meth:`device_table` on the pool's device."""
        return torch.zeros(self.n_pt, dtype=torch.int32, device=self.device)

    # -- shared prefixes ---------------------------------------------------
    def lookup_prefix(self, rid: int, tokens: Sequence[int]) -> int:
        """Map the longest valid registered prefix of ``tokens`` into
        ``rid``'s (empty) page table and return its length (0: a miss). The
        hit is capped at ``len(tokens) - 1`` so at least one token
        prefills: the first token's logits come from the request's own
        pass. Entries whose pages were freed or recycled since the snapshot
        are dropped here."""
        if not self.prefix_sharing:
            return 0
        table = self.tables[rid]
        assert not table, "lookup_prefix must precede any page mapping"
        hit = n_map = 0
        toks = tuple(int(t) for t in tokens)
        for ln in sorted({e.length for e in self._prefix.values()},
                         reverse=True):
            if ln > len(toks):
                continue
            key = toks[:ln]
            entry = self._prefix.get(key)
            if entry is None:
                continue
            if not self._entry_valid(entry):
                del self._prefix[key]
                continue
            hit = min(ln, len(toks) - 1)
            if hit <= 0:
                continue
            n_map = cdiv(hit, self.page)
            for pid in entry.pages[:n_map]:
                self.refcount[pid] += 1
                table.append(pid)
            break
        if self.metrics is not None:
            self.metrics.record_prefix_lookup(hit)
        if self._trace is not None and hit:
            self._trace.prefix_hit(rid, hit, n_map)
        return hit

    def register_prefix(self, rid: int, tokens: Sequence[int]) -> None:
        """Register ``rid``'s prefilled prompt as shareable: one weak entry
        per full-page boundary plus the whole prompt. Snapshots carry page
        generations, no refcounts, so the registry never delays a free."""
        if not self.prefix_sharing:
            return
        table = self.tables[rid]
        toks = tuple(int(t) for t in tokens)
        total = len(toks)
        if total < 2:
            return  # a 1-token prefix can never be reused (hit cap)
        lengths = list(range(self.page, total, self.page)) + [total]
        for ln in lengths:
            n_p = cdiv(ln, self.page)
            if n_p > len(table):
                break
            pages = tuple(table[:n_p])
            self._prefix[toks[:ln]] = _PrefixEntry(
                length=ln, pages=pages,
                gens=tuple(self.generation[p] for p in pages))
            self._prefix.move_to_end(toks[:ln])
        while len(self._prefix) > self.MAX_PREFIX_ENTRIES:
            self._prefix.popitem(last=False)

    def _entry_valid(self, entry: _PrefixEntry) -> bool:
        return all(
            self.refcount[p] > 0 and self.generation[p] == g
            for p, g in zip(entry.pages, entry.gens))

    # -- invariants --------------------------------------------------------
    def check_balanced(self) -> None:
        """The drained pool: no resident request, every refcount zero, and
        the free list covering the whole pool exactly once."""
        assert not self.tables, f"live page tables: {sorted(self.tables)}"
        leaked = [i for i, c in enumerate(self.refcount) if c != 0]
        assert not leaked, f"nonzero refcounts after drain: {leaked}"
        assert sorted(self._free) == list(range(self.n_pages)), (
            f"free list does not cover the pool: "
            f"{len(self._free)}/{self.n_pages}")
