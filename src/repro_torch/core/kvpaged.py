"""Paged KV cache: page-table layout, offload to pinned host memory, prefix
reuse.

The stacked ``(L, B, KV, S, hd)`` cache holds ``max_batch x max_seq``
tokens of KV for every layer up front. This module replaces it with a
paged layout, as the reference's ``core/kvpaged.py`` does:

- a fixed **page pool** per cache side on the device, ``(P, KV,
  page_size, hd)`` bf16 pages, zero-filled (a masked position's softmax
  weight is exactly 0.0, and 0 * 0 keeps it out of ``p @ v``; an
  uninitialised page could hold NaN, and 0 * NaN is NaN). Page 0 is the
  *null write sink*: masked writes land there instead of branching, so it
  holds garbage and is never read unmasked;
- a host-side **page table** mapping logical blocks (one per ``(layer,
  slot, block)`` span of ``page_size`` tokens) to physical pages, kept by
  a free-list allocator with LRU eviction of cold pages to pinned host
  memory and demand restore through the executor's ``PrefetchEngine``
  demand pool (``kv_page`` shards beside the cold experts, under the same
  ``streamed == plan + demanded`` ledger);
- a **prefix cache** that hashes prompt prefixes at block granularity: a
  shared system prompt is prefilled once, later admissions map its
  read-only pages and prefill only the suffix.

``PageAllocator``, ``_Block``, ``PagePoolFull``, ``PagedKVStats``,
``PAGE_SIZE`` and ``NULL_PAGE`` are the reference's, copied verbatim (they
are pure Python): the allocator decides page ids and eviction victims and
reports them through callbacks, and ``PagedKVCache`` moves the data.

Ordering on the card. An eviction's write-back is a device-to-host copy
into a slot of a pinned arena (``HostPages``), issued on the compute
stream: it runs after every write the compute stream issued to that page,
and before anything that later reuses the page id (a scatter of this pass,
a restore's fold), since those are issued on the same stream after it. A
CUDA event recorded after the copy (``host_ready``) is what a restore's
host-to-device copy, on another stream, waits for before it reads the
host slot.

``fault_plan`` (set by the executor, ``core/faults.py``) is the
``alloc.host`` injection point: ``_collect`` fires it before any block is
made or copied on write, so an injected allocation failure leaves the
table as it was and the serving ladder can re-run the pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

PAGE_SIZE = 16      # tokens per KV block (one page per cache side)
NULL_PAGE = 0       # physical page reserved as the masked-write sink


class PagePoolFull(RuntimeError):
    """Every physical page is pinned by the in-flight pass — the pool is
    smaller than one pass's working set. Grow ``kv_pool_pages`` (at least
    one layer of blocks for the active slots, plus slack)."""


@dataclass
class _Block:
    """One logical KV block (``page_size`` tokens of one layer of one
    sequence — possibly shared across sequences via the prefix cache)."""
    bid: int
    pid: int = -1            # physical page when resident, -1 when host
    refs: int = 0            # logical mappings: slot tables + prefix cache
    dirty: bool = False      # device copy newer than the host copy
    has_host: bool = False   # a host copy exists (stale iff dirty)
    last_use: int = 0


class PageAllocator:
    """Free-list page allocator with LRU eviction — pure host bookkeeping.

    Physical pages ``1..n_pages-1`` are allocatable (0 is the null sink).
    Blocks are refcounted: ``new_block`` maps a fresh page (evicting the
    LRU unpinned resident block when the free list is empty), ``release``
    drops one mapping and frees the page at refcount zero. ``assign``
    re-pages a host-resident block (the caller moves the data — the
    demand-streamed restore path); ``ensure_resident`` is the synchronous
    convenience that also fires ``on_restore``. Data movement happens in
    the ``on_evict(bid, pid)`` / ``on_restore(bid, pid)`` callbacks so the
    allocator itself stays model-checkable.
    """

    def __init__(self, n_pages: int, on_evict=None, on_restore=None):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page beyond the "
                             f"null sink (n_pages={n_pages})")
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages - 1, NULL_PAGE, -1))
        self.blocks: Dict[int, _Block] = {}
        self.by_pid: Dict[int, int] = {}          # resident pid -> bid
        self.pinned: set = set()                  # bids the pass holds
        self.on_evict = on_evict or (lambda bid, pid: None)
        self.on_restore = on_restore or (lambda bid, pid: None)
        self._next_bid = 1
        self._tick = 0
        self.evictions = 0
        self.writebacks = 0                       # evictions that moved data
        self.restores = 0

    # ------------------------------------------------------------ clock
    def _clock(self) -> int:
        self._tick += 1
        return self._tick

    def touch(self, bid: int):
        self.blocks[bid].last_use = self._clock()

    # ------------------------------------------------------------ pages
    def _evict_one(self) -> int:
        """Evict the LRU unpinned resident block; returns its freed pid."""
        victim = None
        for bid in self.by_pid.values():
            if bid in self.pinned:
                continue
            b = self.blocks[bid]
            if victim is None or b.last_use < victim.last_use:
                victim = b
        if victim is None:
            raise PagePoolFull(
                f"all {self.n_pages - 1} pages pinned by the in-flight pass")
        pid = victim.pid
        if victim.dirty or not victim.has_host:
            self.on_evict(victim.bid, pid)        # caller copies dev -> host
            victim.has_host = True
            victim.dirty = False
            self.writebacks += 1
        del self.by_pid[pid]
        victim.pid = -1
        self.evictions += 1
        return pid

    def _take_page(self) -> int:
        return self.free.pop() if self.free else self._evict_one()

    # ------------------------------------------------------------ blocks
    def new_block(self) -> int:
        """Map a fresh logical block onto a physical page (refcount 1)."""
        pid = self._take_page()
        bid = self._next_bid
        self._next_bid += 1
        self.blocks[bid] = _Block(bid=bid, pid=pid, refs=1,
                                  last_use=self._clock())
        self.by_pid[pid] = bid
        return bid

    def retain(self, bid: int):
        self.blocks[bid].refs += 1

    def release(self, bid: int) -> bool:
        """Drop one mapping; frees the block (and its page) at refcount 0.
        Returns True when the block died (the owner drops host data)."""
        b = self.blocks[bid]
        b.refs -= 1
        if b.refs > 0:
            return False
        if b.pid >= 0:
            del self.by_pid[b.pid]
            self.free.append(b.pid)
        self.pinned.discard(bid)
        del self.blocks[bid]
        return True

    def refs(self, bid: int) -> int:
        return self.blocks[bid].refs

    def resident(self, bid: int) -> bool:
        return self.blocks[bid].pid >= 0

    def pid(self, bid: int) -> int:
        return self.blocks[bid].pid

    def mark_dirty(self, bid: int):
        self.blocks[bid].dirty = True

    # ------------------------------------------------------------ pinning
    def pin(self, bids):
        self.pinned.update(bids)

    def unpin(self, bids):
        self.pinned.difference_update(bids)

    # ------------------------------------------------------------ restore
    def assign(self, bid: int) -> int:
        """Re-page a host-resident block (demand stream-back: the CALLER
        writes the staged data into the returned pid)."""
        b = self.blocks[bid]
        assert b.pid < 0, f"block {bid} already resident"
        assert b.has_host, f"block {bid} has no host copy to restore"
        pid = self._take_page()
        b.pid = pid
        b.last_use = self._clock()
        self.by_pid[pid] = bid
        self.restores += 1
        return pid

    def ensure_resident(self, bids) -> List[Tuple[int, int]]:
        """Synchronously restore every host-resident block of ``bids``;
        returns the ``(bid, pid)`` assignments (``on_restore`` fired for
        each)."""
        out = []
        for bid in bids:
            self.touch(bid)
            if not self.resident(bid):
                pid = self.assign(bid)
                self.on_restore(bid, pid)
                out.append((bid, pid))
        return out

    # ------------------------------------------------------------ invariants
    def check(self):
        """The property-test surface: free list and resident pages
        partition the physical pool, no page is double-mapped, and every
        live block is reachable (resident or host-backed)."""
        assert NULL_PAGE not in self.free and NULL_PAGE not in self.by_pid
        assert len(set(self.free)) == len(self.free), "free list duplicates"
        resident = {b.pid for b in self.blocks.values() if b.pid >= 0}
        assert not (set(self.free) & resident), "freed page still mapped"
        assert set(self.free) | resident == set(range(1, self.n_pages)), \
            "free list + resident pages must partition the pool"
        pids = [b.pid for b in self.blocks.values() if b.pid >= 0]
        assert len(set(pids)) == len(pids), "physical page double-mapped"
        assert self.by_pid == {b.pid: b.bid for b in self.blocks.values()
                               if b.pid >= 0}
        for b in self.blocks.values():
            assert b.refs > 0, f"block {b.bid} alive at refcount 0"
            assert b.pid >= 0 or b.has_host, \
                f"block {b.bid} unreachable (not resident, no host copy)"


@dataclass
class PagedKVStats:
    """Counters the conformance suite and ``Session.stats`` read."""
    page_faults: int = 0            # blocks restored (sync or demand)
    demanded_page_bytes: int = 0    # bytes those restores moved host->dev
    evictions: int = 0
    evicted_page_bytes: int = 0     # bytes eviction write-backs moved
    cow_copies: int = 0
    prefix_queries: int = 0
    prefix_hits: int = 0            # admissions that matched >= 1 block
    prefix_hit_blocks: int = 0      # total shared blocks mapped
    prefix_entries: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class HostPages:
    """Host slots for evicted blocks, each a ``(2, KV, page_size, hd)``
    view (k then v) into a chunk of ``chunk`` slots. On a CUDA device the
    chunks are page-locked, so write-backs and restores are asynchronous
    copies; a chunk is allocated once and its slots are reused, so an
    eviction never asks the driver for pinned memory."""

    def __init__(self, shape, dtype, pinned: bool, chunk: int = 256):
        self.shape, self.dtype, self.pinned = tuple(shape), dtype, pinned
        self.chunk = chunk
        self._free: List[torch.Tensor] = []
        self.chunks = 0

    def take(self) -> torch.Tensor:
        if not self._free:
            block = torch.zeros((self.chunk,) + self.shape, dtype=self.dtype,
                                pin_memory=self.pinned)
            self._free = list(block.unbind(0))[::-1]
            self.chunks += 1
        return self._free.pop()

    def give(self, slot: torch.Tensor):
        self._free.append(slot)


class PagedKVCache:
    """Device page pools + page table + prefix cache for one serving batch.

    The executor drives it pass by pass: ``prepare_decode`` /
    ``prepare_prefill`` / ``prepare_verify`` allocate write blocks and
    compute the per-layer needed sets, ``begin_layer``/``end_layer``
    bracket each layer's attention step (pin the layer's blocks, report
    what must be restored first), and ``fold`` lands restored page data in
    the pool. ``layer_table`` gives the physical-page table the paged
    engine steps gather through, on the device.
    """

    def __init__(self, cfg, max_batch: int, max_seq: int,
                 page_size: int = PAGE_SIZE, n_pages: Optional[int] = None,
                 prefix_cache: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_size = page_size
        self.n_blocks = -(-max_seq // page_size)
        hd = cfg.resolved_head_dim
        KV = cfg.n_kv_heads
        # bytes of ONE block across both cache sides (k + v), bf16
        self.page_bytes = KV * page_size * hd * 2
        self.block_bytes = 2 * self.page_bytes
        if n_pages is None:
            # ample default: the full stacked demand never evicts — paged
            # is then a pure layout change
            n_pages = cfg.n_layers * max_batch * self.n_blocks + 1
        self.n_pages = n_pages
        shape = (n_pages, KV, page_size, hd)
        self.k_pool = torch.zeros(shape, dtype=torch.bfloat16,
                                  device=self.device)
        self.v_pool = torch.zeros(shape, dtype=torch.bfloat16,
                                  device=self.device)
        # logical block ids per (layer, slot, block); -1 = unmapped
        self.bids = np.full((cfg.n_layers, max_batch, self.n_blocks), -1,
                            np.int64)
        self._cuda = self.device.type == "cuda"
        self.host_pages = HostPages((2, KV, page_size, hd), torch.bfloat16,
                                    pinned=self._cuda)
        # bid -> its host slot, and (write-back count, the event after its
        # last write-back): the count orders events of the one stream
        self.host: Dict[int, torch.Tensor] = {}
        self._host_ready: Dict[int, Tuple[int, torch.cuda.Event]] = {}
        self._writebacks = 0
        self.alloc = PageAllocator(n_pages, on_evict=self._evict_cb)
        self.stats = PagedKVStats()
        self.prefix_enabled = prefix_cache
        # chain-hash key -> per-layer bids for ONE block position
        self._prefix: Dict[tuple, List[int]] = {}
        # per-pass state
        self._pass_needed: List[List[int]] = []
        self._pass_written: List[set] = []
        # alloc.host fault injection (set by the executor); named
        # fault_plan because faults() is the pass-fault list
        self.fault_plan = None

    # ------------------------------------------------------------ movement
    def _evict_cb(self, bid: int, pid: int):
        """LRU eviction write-back: pool page -> the block's pinned host
        slot, on the compute stream (see the module docstring)."""
        slot = self.host.get(bid)
        if slot is None:
            slot = self.host[bid] = self.host_pages.take()
        slot[0].copy_(self.k_pool[pid], non_blocking=self._cuda)
        slot[1].copy_(self.v_pool[pid], non_blocking=self._cuda)
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._writebacks += 1
            self._host_ready[bid] = (self._writebacks, ev)
        self.stats.evictions += 1
        self.stats.evicted_page_bytes += self.block_bytes

    def host_tree(self, bid: int) -> dict:
        """Host-resident page data as a weight tree for the prefetch
        demand pool (the ``kv_page`` shard kind)."""
        slot = self.host[bid]
        return {"k": slot[0], "v": slot[1]}

    def host_ready(self, bids):
        """The CUDA event after the last write-back of any of ``bids``
        (None on the CPU, or when none was written back): a copy of their
        host slots to the device waits for it. Write-backs all run on the
        compute stream, so the latest one follows every earlier one."""
        marks = [self._host_ready[b] for b in bids if b in self._host_ready]
        return max(marks, key=lambda m: m[0])[1] if marks else None

    def layer_fault_bytes(self, faults) -> int:
        """Bytes of the largest one-layer restore among ``faults``
        ((layer, bid) pairs): what a demand slot must hold, since a layer's
        evicted blocks go to the card as one entry."""
        per_layer: Dict[int, int] = {}
        for layer, _ in faults:
            per_layer[layer] = per_layer.get(layer, 0) + 1
        return max(per_layer.values(), default=0) * self.block_bytes

    def fold(self, bids: List[int], groups: List[dict]):
        """Land restored blocks in the pools, on the compute stream: page
        ids are assigned (any write-back a victim needs is issued first),
        then one indexed copy per cache side. ``groups``: each block's
        staged ``{"k", "v"}`` on the device. Returns the assigned pids."""
        pids = [self.alloc.assign(bid) for bid in bids]
        idx = self._to_device(np.asarray(pids, np.int64))
        self.k_pool.index_copy_(0, idx, torch.stack([g["k"] for g in groups]))
        self.v_pool.index_copy_(0, idx, torch.stack([g["v"] for g in groups]))
        self.stats.page_faults += len(bids)
        self.stats.demanded_page_bytes += len(bids) * self.block_bytes
        return pids

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host index array on the device. On a CUDA device it is
        staged in pinned memory and copied without blocking the host (the
        caching host allocator keeps the staging buffer until the copy has
        run)."""
        t = torch.from_numpy(arr)
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------ mapping
    def _block_of(self, layer: int, slot: int, j: int, create: bool = False):
        bid = int(self.bids[layer, slot, j])
        if bid < 0:
            if not create:
                return None
            bid = self.alloc.new_block()
            self.bids[layer, slot, j] = bid
        return bid

    def _cow(self, layer: int, slot: int, j: int) -> int:
        """Copy-on-write: the write target is shared (prefix-cached pages
        are read-only) — clone it into a private block first. Full-block
        prefix sharing makes this unreachable in the normal token flow,
        but the guard keeps partial-block sharing safe by construction."""
        old = int(self.bids[layer, slot, j])
        new = self.alloc.new_block()
        pid_new = self.alloc.pid(new)
        if self.alloc.resident(old):
            pid_old = self.alloc.pid(old)
            self.k_pool[pid_new].copy_(self.k_pool[pid_old])
            self.v_pool[pid_new].copy_(self.v_pool[pid_old])
        else:
            # the write-back ran earlier on this same stream
            slot_h = self.host[old]
            self.k_pool[pid_new].copy_(slot_h[0], non_blocking=self._cuda)
            self.v_pool[pid_new].copy_(slot_h[1], non_blocking=self._cuda)
        self.bids[layer, slot, j] = new
        self._release(old)
        self.stats.cow_copies += 1
        return new

    def _release(self, bid: int):
        if self.alloc.release(bid):
            slot = self.host.pop(bid, None)
            self._host_ready.pop(bid, None)
            if slot is not None:
                # later copies into the slot are write-backs on the compute
                # stream, issued after every copy that read this one
                self.host_pages.give(slot)

    def truncate(self, slot: int, keep_tokens: int):
        """Speculative-verify rollback: drop the slot's KV at positions
        ``>= keep_tokens``. Blocks wholly past the keep point are unmapped
        and released — verify's ``_collect`` created them this pass (the
        keep point always covers the pre-pass prefix, since at least one
        verified token is accepted), so releasing them returns the table
        and allocator to their pre-verify mapping exactly. The
        partially-kept block has its rejected offsets zeroed (device page
        or host copy, whichever holds it) so continued decode appends into
        it exactly as sequential decode would. Shared prefix pages are
        unreachable here: verify write targets were COW'd private in
        ``_collect``."""
        ps = self.page_size
        jkeep = -(-keep_tokens // ps)         # blocks covering kept prefix
        for layer in range(self.cfg.n_layers):
            for j in range(jkeep, self.n_blocks):
                bid = int(self.bids[layer, slot, j])
                if bid >= 0:
                    self._release(bid)
                    self.bids[layer, slot, j] = -1
        off = keep_tokens % ps
        if off == 0:
            return
        j = keep_tokens // ps
        synced = False
        for layer in range(self.cfg.n_layers):
            bid = int(self.bids[layer, slot, j])
            if bid < 0:
                continue
            if self.alloc.resident(bid):
                pid = self.alloc.pid(bid)
                self.k_pool[pid, :, off:] = 0
                self.v_pool[pid, :, off:] = 0
                self.alloc.mark_dirty(bid)
            else:
                # the host writes the slot itself: every copy into or out
                # of it must have run first (rare: the block was evicted
                # after its last write of this pass)
                if self._cuda and not synced:
                    torch.cuda.synchronize(self.device)
                    synced = True
                self.host[bid][:, :, off:] = 0

    def prepare_verify(self, pos_by_slot: Dict[int, int], width: int):
        """Allocate one verify pass's write blocks: each slot appends
        ``width`` positions at ``pos .. pos+width-1``. Returns the fault
        list like ``prepare_decode`` (which this equals at
        ``width == 1``)."""
        self._collect((slot, pos + width, pos)
                      for slot, pos in pos_by_slot.items())
        return self.faults()

    def free_slot(self, slot: int):
        """Retire a sequence: unmap its blocks (prefix-cached ones survive
        through the cache's own reference)."""
        for layer in range(self.cfg.n_layers):
            for j in range(self.n_blocks):
                bid = int(self.bids[layer, slot, j])
                if bid >= 0:
                    self._release(bid)
                    self.bids[layer, slot, j] = -1

    # ------------------------------------------------------------ passes
    def _collect(self, spans) -> None:
        """Build the per-layer needed/written sets for one pass.

        ``spans``: iterable of ``(slot, n_tokens_valid, write_from)`` —
        blocks ``0 .. ceil(n/ps)-1`` of every layer are needed (attention
        reads the whole prefix); blocks overlapping ``[write_from, n)``
        are write targets (allocated, COW-guarded, marked dirty).
        """
        # before any block is made: an injected failure leaves the table
        # untouched (a real PagePoolFull from new_block takes the same
        # recovery path)
        if self.fault_plan is not None:
            self.fault_plan.check("alloc.host", key="prepare")
        L = self.cfg.n_layers
        ps = self.page_size
        needed: List[List[int]] = [[] for _ in range(L)]
        written: List[set] = [set() for _ in range(L)]
        for slot, n_valid, write_from in spans:
            jmax = -(-n_valid // ps)              # blocks covering the seq
            jw = write_from // ps                 # first written block
            for layer in range(L):
                for j in range(jmax):
                    create = j >= jw
                    bid = self._block_of(layer, slot, j, create=create)
                    if bid is None:
                        raise RuntimeError(
                            f"slot {slot} layer {layer} block {j} unmapped "
                            "but inside the valid prefix")
                    if create and self.alloc.refs(bid) > 1:
                        bid = self._cow(layer, slot, j)
                    if create:
                        # dirty is marked in begin_layer, under the pin: a
                        # block evicted between prepare and its layer would
                        # write back pre-write content and clear the flag,
                        # silently dropping this pass's token writes.
                        written[layer].add(bid)
                    self.alloc.touch(bid)
                    needed[layer].append(bid)
        self._pass_needed = needed
        self._pass_written = written

    def prepare_decode(self, pos_by_slot: Dict[int, int]):
        """Allocate this iteration's write blocks and compute the fault
        list. Returns ``faults``: (layer, bid) pairs in layer order."""
        self._collect((slot, pos + 1, pos)
                      for slot, pos in pos_by_slot.items())
        return self.faults()

    def prepare_prefill(self, spans):
        """``spans``: (slot, total_tokens, write_from) per admitted row —
        ``write_from`` is the prefix-cache coverage (0 on a cold
        prefill)."""
        self._collect(spans)
        return self.faults()

    def faults(self) -> List[Tuple[int, int]]:
        """Non-resident needed blocks, layer-ascending — the executor uses
        this only to size the demand pool; actual requests go out per layer
        (``begin_layer``) so page demands never sit ahead of an MoE layer's
        expert demands in the demand queue."""
        out = []
        seen = set()
        for layer, bids in enumerate(self._pass_needed):
            for bid in bids:
                if bid not in seen and not self.alloc.resident(bid):
                    seen.add(bid)
                    out.append((layer, bid))
        return out

    def begin_layer(self, layer: int) -> List[int]:
        """Pin this layer's blocks and mark its write targets dirty (both
        hold until ``end_layer``); returns the non-resident blocks the
        executor must restore before the attention step."""
        bids = self._pass_needed[layer]
        self.alloc.pin(bids)
        for bid in self._pass_written[layer]:
            self.alloc.mark_dirty(bid)
        out = []
        seen = set()
        for bid in bids:
            if bid not in seen and not self.alloc.resident(bid):
                seen.add(bid)
                out.append(bid)
        return out

    def end_layer(self, layer: int):
        """Unpin the layer's blocks — from here the LRU may evict them to
        make room for later layers (the sliding-window residency that
        makes the pool smaller than the full cache)."""
        self.alloc.unpin(self._pass_needed[layer])

    def layer_table(self, layer: int, rows: Optional[List[int]] = None):
        """Physical-page table ``(len(rows), n_blocks)`` int64 of this
        layer on the device, for the paged engine steps (``rows`` defaults
        to all slots; admission prefill passes the single admitted slot).
        Unmapped and host cells read the null page — their positions are
        masked out of attention. Copied to the card by ``_to_device``,
        without blocking the host."""
        if rows is None:
            rows = list(range(self.max_batch))
        t = np.zeros((len(rows), self.n_blocks), np.int64)
        blocks = self.alloc.blocks
        for r, slot in enumerate(rows):
            for j, bid in enumerate(self.bids[layer, slot]):
                if bid >= 0:
                    pid = blocks[int(bid)].pid
                    if pid >= 0:
                        t[r, j] = pid
        return self._to_device(t)

    # ------------------------------------------------------------ prefix
    @staticmethod
    def _chain_keys(tokens: np.ndarray, page_size: int):
        """Chained block hashes of a prompt's FULL blocks: key_j commits to
        every token up to and including block j, so equal keys imply equal
        token prefixes (and therefore bit-equal KV)."""
        keys = []
        prev: tuple = ("kv-prefix",)
        for j in range(len(tokens) // page_size):
            prev = (prev, tuple(int(t) for t in
                                tokens[j * page_size:(j + 1) * page_size]))
            keys.append(prev)
        return keys

    def prefix_attach(self, slot: int, tokens: np.ndarray) -> int:
        """Map the longest cached chain of full blocks into ``slot``'s
        table (read-only shares). Returns covered token count — capped one
        token short of the prompt so the suffix prefill always has a last
        position to produce logits from."""
        if not self.prefix_enabled:
            return 0
        self.stats.prefix_queries += 1
        keys = self._chain_keys(tokens, self.page_size)
        matched = 0
        for key in keys:
            if key not in self._prefix:
                break
            if (matched + 1) * self.page_size >= len(tokens):
                break                               # keep >= 1 suffix token
            matched += 1
        if matched == 0:
            return 0
        for j in range(matched):
            bids = self._prefix[keys[j]]
            for layer in range(self.cfg.n_layers):
                bid = bids[layer]
                assert self.bids[layer, slot, j] < 0, \
                    "prefix_attach into an occupied slot"
                self.bids[layer, slot, j] = bid
                self.alloc.retain(bid)
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_blocks += matched
        return matched * self.page_size

    def prefix_register(self, slot: int, tokens: np.ndarray):
        """Publish the slot's full prompt blocks into the prefix cache
        (the cache retains its own reference, so the pages outlive the
        request)."""
        if not self.prefix_enabled:
            return
        for j, key in enumerate(self._chain_keys(tokens, self.page_size)):
            if key in self._prefix:
                continue
            bids = [int(self.bids[layer, slot, j])
                    for layer in range(self.cfg.n_layers)]
            if any(b < 0 for b in bids):
                continue
            for bid in bids:
                self.alloc.retain(bid)
            self._prefix[key] = bids
        self.stats.prefix_entries = len(self._prefix)

    # ------------------------------------------------------------ reporting
    def resident_block_count(self) -> int:
        return len(self.alloc.by_pid)

    def stats_dict(self) -> dict:
        out = self.stats.as_dict()
        out.update({
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pool_bytes": (self.n_pages - 1) * self.block_bytes,
            "resident_blocks": self.resident_block_count(),
            "host_blocks": len(self.host),
        })
        return out
