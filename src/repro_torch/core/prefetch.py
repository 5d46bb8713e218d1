"""Async weight prefetch: pipelined copy-compute over a real PCIe link.

The paper overlaps PCIe weight streaming with GPU compute through a VRAM
scratch double-buffer. The reference simulated the link with
``jax.device_put`` on the CPU backend; here it is the card's:

- the executor keeps every host copy of the weights in pinned (page-locked)
  memory, so a ``non_blocking`` copy really runs asynchronously;
- one worker thread walks the plan's ``static_stream_order`` (streamed
  placements in execution order) and stages each sub-layer's weights with
  ``.to(device, non_blocking=True)`` on a dedicated copy stream, recording
  one CUDA event per staged sub-layer. The current stream is per thread, so
  the worker enters the copy stream itself;
- slot occupancy is bounded by a semaphore sized from the schedule's
  scratch (2 slots when it fits a double-buffer of the largest streamed
  sub-layer, else 1);
- ``acquire(name)`` blocks until that sub-layer's copy has landed; the wait
  is the *exposed* copy time and ``copy_s - exposed`` the *hidden* time.
  The compute stream then waits on the copy's event, and every staged
  tensor is marked as used by the compute stream (``record_stream``), so
  the caching allocator cannot hand its memory to the next copy while
  compute still reads it;
- ``release(name)`` drops the engine's reference after compute is issued
  (the caller has dropped its own) and records an event on the compute
  stream. Before the worker stages into the freed slot it waits for that
  event, so a slot's memory is reused only once the compute that read it
  has run: the host may run ahead of the card, but the staged weights on
  the device never exceed the slots the scratch allows.

On the CPU (the tests) there is no link: staging is a no-op ``.to("cpu")``
on the worker thread, with the same slots, order and accounting.

Demand streaming (expert-granular MoE, paged-KV restores): which cold
experts a pass needs is known only once each layer's router has run, and
which evicted KV blocks once the layer's pages are pinned, so a session
started with ``demand_bytes > 0`` takes ``request()`` calls mid-pass. The demand pool
has its own slots (1 or 2, from what the static slots leave of the
scratch), each a device buffer kept for the session, and its own copy
stream. Unlike the reference's, it has no worker thread: the consumer
issues each demanded copy itself, on ``request()`` while a slot is free
and on the ``release()`` that frees one, and nothing waits for a copy on
the host. The copy stream waits for the slot's freed-slot event (its last
reader's compute) before it writes the slot, and for a KV block's
write-back event (``sub.meta["ready"]``) before it reads the block's host
copy; the compute stream waits for the copy's event before it reads the
slot. A thread handing each expert
over cost about as much host time as the copies it hid (``copy_modes.py``
on the card, PERF.md), as the two threads traded the interpreter lock at
every op. Separate pools keep demands deadlock-free: the static worker may
hold every static slot for layers ahead of the consumer, and a demanded
expert never waits for them.

Fault tolerance (``core/faults.py``): a stage copy fires ``prefetch.copy``
(static) or ``demand.copy`` (demand) once per attempt and retries with
backoff under ``RecoveryPolicy`` before its error reaches ``acquire``; an
attempt issues its copies and records the ready event only once the fault
check and the host fetch have passed, so a failed attempt leaves no copy
the consumer could wait on, and ``staged_bytes`` counts the attempt that
succeeded, once. ``acquire(name, timeout=)`` raises ``DemandTimeout`` when
the static pool's host wait runs past the deadline; the consumer then
``abandon()``s the entry (or ``discard()``s a failed one) and fetches the
shard itself. The static worker fires ``prefetch.worker`` per item before
staging it; if anything kills it (that point's ``crash``, or a CUDA error
in ``_take_slot``'s wait), ``_worker_died`` fails every pending entry of
its pool with ``WorkerLost`` and records ``worker_error``, so ``acquire``,
``discard`` and ``finish`` return instead of waiting forever.

The demand pool has no worker thread, so the reference's demand worker
maps onto ``_issue_demands``: ``demand.worker`` fires there once per entry,
before the entry is staged (the reference's position per item, hits in
request order). Its ``crash`` marks the pool dead for the session, as the
reference's ``_worker_died("demand")``: that entry and every queued one
fail with ``WorkerLost``, later ``request()`` calls fail their entries up
front, ``worker_crashes`` counts one, and the exception never leaves
``request()`` or ``release()``. No host thread waits for a demand copy, so
the demand path has no organic ``DemandTimeout``: only an injected
``demand.timeout`` (fired by the executor) raises it there.

Page entries are coarser than the reference's: there each evicted KV block
is a demand entry of its own, here a layer's evicted blocks are one
``kv_page`` entry. ``demand.copy`` and ``demand.timeout`` hits on a paged
run therefore count differently in the two packages; on static and expert
entries they count alike.

An error raised by CUDA itself (``is_device_error``) poisons the context:
it is not retried, not counted as a copy failure, and reaches the consumer
as it is, which lets it propagate. Only injected faults and host-side
failures go through recovery.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from repro_torch.core.faults import (DemandTimeout, FaultError, FaultPlan,
                                     RecoveryPolicy, WorkerLost)
from repro_torch.models.common import tree_leaves, tree_map, tree_nbytes


def is_device_error(exc: Optional[BaseException]) -> bool:
    """True when ``exc``, or an error it was raised from, is an error of
    CUDA itself (``torch.AcceleratorError`` where PyTorch has it, a
    ``RuntimeError`` reading "CUDA error" or "CUDA driver error", or a CUDA
    out-of-memory error). Such an error is not recovered from: retrying a
    copy or fetching the shard again would hide the device's fault. An
    injected ``FaultError`` never is one."""
    accel = getattr(torch, "AcceleratorError", None)
    while exc is not None:
        if isinstance(exc, FaultError):
            return False
        if accel is not None and isinstance(exc, accel):
            return True
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        if isinstance(exc, RuntimeError) and str(exc).startswith(
                ("CUDA error", "CUDA driver error")):
            return True
        exc = exc.__cause__
    return False


def drop_traceback(exc: BaseException):
    """Forget a handled error's traceback. An injected fault's traceback
    holds the frame of ``FaultPlan.check``, whose local holds the fault,
    and a failed entry's error is held by the entry, a local of
    ``acquire``'s frame: cycles that keep every frame of the traceback
    alive, and their callers' (a frame holds its caller), with what they
    hold on the card (a layer's dispatch buffers, a shard fetched in a
    failed entry's place), until the garbage collector runs."""
    exc.__traceback__ = None


@dataclass
class PrefetchStats:
    copy_s_hidden: float = 0.0   # copy time overlapped under compute
    copy_s_exposed: float = 0.0  # copy time the consumer actually waited
    staged_bytes: int = 0        # actual bytes moved host->device
    staged_sublayers: int = 0
    slots: int = 0               # realised double-buffer depth (0: no session)
    demand_slots: int = 0        # realised demand-pool depth
    demanded_sublayers: int = 0  # entries staged through the demand queue
    copy_retries: int = 0        # stage copies retried after a failure
    copy_failures: int = 0       # stage copies that exhausted their retries
    worker_crashes: int = 0      # static worker deaths, demand pool deaths
    abandoned: int = 0           # entries dropped past their deadline


class _Staged:
    __slots__ = ("event", "tree", "copy_s", "error", "copied", "pool",
                 "abandoned", "holds_slot", "slot")

    def __init__(self, pool: str = "static"):
        self.event = threading.Event()   # set once the copy has landed
        self.tree = None
        self.copy_s = 0.0
        self.error: Optional[BaseException] = None
        self.copied = None               # CUDA event recorded after the copy
        self.pool = pool                 # "static" or "demand"
        self.abandoned = False
        self.holds_slot = False          # a worker took a slot for it
        self.slot = None                 # the demand slot it was copied to


_ALIGN = 256    # bytes: each leaf of a packed allocation starts on this


def _aligned(t) -> int:
    return -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN


def packed_nbytes(groups) -> int:
    """Device bytes ``groups`` take packed, each leaf aligned."""
    return sum(_aligned(t) for g in groups for t in tree_leaves(g))


def _pack(leaves, device, non_blocking, buf=None, offset=0):
    """``leaves`` copied to ``device`` as views into one allocation: into
    ``buf`` from byte ``offset`` on, or into a new one."""
    if not leaves:
        return []
    sizes = [_aligned(t) for t in leaves]
    if buf is None:
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    out = []
    for t, n in zip(leaves, sizes):
        view = buf[offset:offset + t.numel() * t.element_size()] \
            .view(t.dtype).view(t.shape)
        out.append(view.copy_(t, non_blocking=non_blocking))
        offset += n
    return out


def _rebuild(tree, leaves):
    """``tree``'s nesting with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def groups_nbytes(groups) -> int:
    return sum(tree_nbytes(g) for g in groups)


def groups_to_device(groups, device, non_blocking=False):
    """``groups``, a list of weight trees, on ``device``. On a CUDA card
    each group's leaves are views into one allocation of its own (each
    leaf 256-byte aligned): many small allocations would each be rounded
    by the caching allocator (1.5 MiB int8 matrices, 13 to a 20 MiB
    segment, leave the thirteenth its segment's last half MiB: 2.6% over
    the bytes the plan prices). The caller chooses the groups, and so
    which leaves share an allocation. On the CPU the leaves are returned
    as they are. (Plain functions, no nested closures: a self-referencing
    closure would keep the device views alive until the garbage collector
    ran.)"""
    if device.type != "cuda":
        return [tree_map(lambda t: t.to(device), g) for g in groups]
    return [_rebuild(g, iter(_pack(tree_leaves(g), device, non_blocking)))
            for g in groups]


def stage_groups(groups, device, stream, ready=None):
    """Copy a list of host weight trees to ``device`` on ``stream``
    (``groups_to_device``) and wait for it on the calling thread only.
    ``ready``: a CUDA event the copy must follow on the card (a paged-KV
    block's write-back into the host memory it reads). Returns (device
    groups, CUDA event or None)."""
    if device.type != "cuda":
        return groups_to_device(groups, device), None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        dev = groups_to_device(groups, device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    copied.synchronize()
    return dev, copied


def hand_to_compute(groups, copied, device):
    """Order the current (compute) stream after a staged copy, and mark the
    staged tensors as used by it so their memory is not reused early."""
    if copied is None:
        return groups
    cur = torch.cuda.current_stream(device)
    cur.wait_event(copied)
    for g in groups:
        for t in tree_leaves(g):
            t.record_stream(cur)
    return groups


class PrefetchEngine:
    """Background-thread transfer queue over a plan's streamed placements.

    ``fetch_host(sub)`` returns the host-resident (pinned) weights of a
    sub-layer as a list of trees, one device allocation each
    (``groups_to_device``); the engine copies them to ``device`` and hands
    the device list to ``acquire`` in FIFO order.
    """

    def __init__(self, fetch_host: Callable, device: torch.device,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None):
        self._fetch_host = fetch_host
        self.device = device
        self.faults = faults
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        self.stats = PrefetchStats()
        # set when a pool's staging died this session (WorkerLost)
        self.worker_error: Optional[WorkerLost] = None
        self.demand_worker_error: Optional[WorkerLost] = None
        cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if cuda else None
        self._demand_stream = torch.cuda.Stream(device) if cuda else None
        self._thread: Optional[threading.Thread] = None
        self._staged: dict = {}
        self._sem: Optional[threading.Semaphore] = None
        self._lock = threading.Lock()   # stats and entry hand-offs
        # one CUDA event per released static slot, recorded on the compute
        # stream after the slot's last reader; kept across sessions so the
        # next pass's first copies also wait for the previous pass's
        # readers
        self._freed: deque = deque()
        # demand pool, touched by the consumer thread only: requested
        # entries not yet copied, the free slots (None: no pool), and per
        # slot its buffer and the event after its last reader
        self._demand_q: deque = deque()
        self._demand_free: Optional[list] = None
        self._demand_bufs: list = []
        self._demand_freed: list = []

    @property
    def active(self) -> bool:
        """True while a staging session is running; a live re-plan
        (``PipelinedExecutor.rebind``) must wait for the pass to finish."""
        return self._thread is not None or self._demand_free is not None

    # ------------------------------------------------------------ session
    @staticmethod
    def slots_for(order, avail_bytes: Optional[int]) -> int:
        """Double-buffer when the weight portion of the scratch (scratch
        minus the activation reservation) fits two of the largest streamed
        sub-layers, else degrade to a single (synchronous) slot."""
        if avail_bytes is None:
            return 2
        max_w = max((p.sub.weight_bytes for p in order), default=0)
        return 2 if avail_bytes >= 2 * max_w else 1

    def start(self, order: List, avail_bytes: Optional[int] = None,
              demand_bytes: int = 0):
        """Begin staging ``order`` (Placement list) one sub-layer ahead.

        Every item of ``order`` MUST be acquire()d and release()d by the
        consumer in this exact sequence (or the session finish()ed early) —
        a skipped item would hold its scratch slot for the whole pass.

        ``demand_bytes > 0`` also opens the session to mid-pass
        ``request()`` calls; it is the largest shard a request may carry,
        and sizes the demand pool from what the static slots leave of
        ``avail_bytes`` (2 slots when that fits two shards, else 1)."""
        assert not self.active, "prefetch session already active"
        if not order and demand_bytes <= 0:
            return
        names = [p.sub.name for p in order]
        assert len(set(names)) == len(names), "duplicate sub-layer in order"
        self.stats.slots = self.slots_for(order, avail_bytes)
        self._sem = threading.Semaphore(self.stats.slots)
        self._staged = {n: _Staged() for n in names}
        self.worker_error = None
        self.demand_worker_error = None
        if demand_bytes > 0:
            if avail_bytes is None:
                self.stats.demand_slots = 2
            else:
                max_static = max((p.sub.weight_bytes for p in order),
                                 default=0)
                remaining = avail_bytes - self.stats.slots * max_static
                self.stats.demand_slots = \
                    2 if remaining >= 2 * demand_bytes else 1
            slots = self.stats.demand_slots
            self._demand_q = deque()
            self._demand_free = list(range(slots - 1, -1, -1))
            self._demand_bufs = [None] * slots
            self._demand_freed = [None] * slots
        else:
            self.stats.demand_slots = 0
        if order:
            self._thread = threading.Thread(
                target=self._worker, args=(list(order),), daemon=True)
            self._thread.start()

    def _copy_with_retries(self, pl, point: str, stage):
        """Fetch ``pl``'s host groups and ``stage`` them, retrying a failed
        attempt with backoff under the recovery policy; ``point`` fires
        once per attempt, before anything is fetched or issued. Returns
        (host groups, what ``stage`` returned) or raises the last error. A
        device error is neither retried nor counted."""
        pol = self.recovery
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.check(point, key=pl.sub.name)
                host = self._fetch_host(pl.sub)
                return host, stage(host)
            except BaseException as e:
                if is_device_error(e):
                    raise
                if attempt >= pol.max_copy_retries or not pol.retryable(e):
                    with self._lock:
                        self.stats.copy_failures += 1
                    raise
                with self._lock:
                    self.stats.copy_retries += 1
                drop_traceback(e)
                pol.sleep(pol.backoff_s(attempt))
                attempt += 1

    def _stage_one(self, pl, st: _Staged):
        st.holds_slot = True
        try:
            t0 = time.perf_counter()
            host, (st.tree, st.copied) = self._copy_with_retries(
                pl, "prefetch.copy",
                lambda h: stage_groups(h, self.device, self._stream))
            st.copy_s = time.perf_counter() - t0
            with self._lock:
                self.stats.staged_bytes += groups_nbytes(host)
                self.stats.staged_sublayers += 1
        except BaseException as e:   # surfaced to the consumer on acquire
            st.error = e
        finally:
            with self._lock:
                st.event.set()
                if st.abandoned:   # the consumer dropped it meanwhile
                    st.tree = None
                    self._free_slot(None)

    def _take_slot(self):
        """Block for a free static slot; once the slot's last reader has
        run on the card, it may be staged into."""
        self._sem.acquire()
        if self._freed:
            self._freed.popleft().synchronize()

    def _free_slot(self, done):
        if done is not None:
            self._freed.append(done)
        self._sem.release()

    def _worker(self, order):
        try:
            for pl in order:
                self._take_slot()
                if self.faults is not None:
                    self.faults.check("prefetch.worker", key=pl.sub.name)
                self._stage_one(pl, self._staged[pl.sub.name])
        except BaseException as e:
            self._worker_died(e)

    def _worker_died(self, exc: BaseException):
        """The static worker died outside an item's staging: fail every
        pending entry of its pool with ``WorkerLost`` (the cause chained),
        so a blocked ``acquire`` or ``finish`` wakes instead of waiting
        forever. The dead pool's semaphore may be over-released later,
        harmlessly: each ``start`` makes a new one."""
        err = WorkerLost(f"static prefetch worker died: {exc!r}")
        err.__cause__ = exc
        with self._lock:
            self.stats.worker_crashes += 1
            self.worker_error = err
            for st in list(self._staged.values()):
                if st.pool == "static" and not st.event.is_set():
                    st.error = err
                    st.event.set()

    def _demand_died(self, exc: BaseException, staging: _Staged):
        """The demand pool's staging died (an injected ``demand.worker``
        crash): the entry it was staging and every queued one fail with
        ``WorkerLost``; later requests of this session fail up front."""
        err = WorkerLost(f"demand prefetch worker died: {exc!r}")
        # the cause was raised on the consumer's thread, inside whatever
        # layer requested or released: its frames hold that layer's buffers
        drop_traceback(exc)
        err.__cause__ = exc
        self.demand_worker_error = err
        with self._lock:
            self.stats.worker_crashes += 1
        for st in [staging] + [st for _, st in self._demand_q]:
            st.error = err
            st.event.set()
        self._demand_q.clear()

    # ------------------------------------------------------------ demand
    def request(self, placements: List):
        """Queue demand-streamed shards mid-pass (router-selected cold
        experts), and copy as many as there are free demand slots. Each
        must be acquire()d and release()d, in request order, before the
        pass finishes; the release of one copies the next into its slot.
        Only on sessions started with ``demand_bytes > 0``."""
        assert self._demand_free is not None, \
            "request() on a session without a demand pool"
        for pl in placements:
            name = pl.sub.name
            assert name not in self._staged, \
                f"{name} already staged or requested this pass"
            st = self._staged[name] = _Staged(pool="demand")
            if self.demand_worker_error is not None:
                # a dead pool stages nothing more this session
                st.error = self.demand_worker_error
                st.event.set()
            else:
                self._demand_q.append((pl, st))
        self._issue_demands()

    def _issue_demands(self):
        """Copy queued demand entries, in request order, into free slots.
        The host does not wait for the copies (``copy_s`` stays 0). Each
        entry fires ``demand.worker`` before it is staged; a crash there
        kills the pool (``_demand_died``) and is not raised."""
        while self._demand_q and self._demand_free:
            pl, st = self._demand_q.popleft()
            if self.faults is not None:
                try:
                    self.faults.check("demand.worker", key=pl.sub.name)
                except Exception as e:
                    self._demand_died(e, st)
                    return
            st.slot = self._demand_free.pop()
            # a shard whose host data is still being written carries the
            # write's event in its meta (paged-KV write-backs)
            ready = getattr(pl.sub, "meta", {}).get("ready")
            with self._lock:
                self.stats.demanded_sublayers += 1
            try:
                host, (st.tree, st.copied) = self._copy_with_retries(
                    pl, "demand.copy",
                    lambda h: self._stage_into_slot(h, st.slot, ready))
                with self._lock:
                    self.stats.staged_bytes += groups_nbytes(host)
                    self.stats.staged_sublayers += 1
            except Exception as e:   # surfaced to the consumer on acquire
                st.error = e
            st.event.set()

    def _stage_into_slot(self, groups, slot, ready=None):
        """``groups`` packed into demand slot ``slot``'s buffer on the
        demand stream, once the slot's last reader has run on the card
        (and ``ready``, if given, the host data's last write: a paged-KV
        block's write-back). Returns (device groups, CUDA event after the
        copy, or None)."""
        if self.device.type != "cuda":
            return groups_to_device(groups, self.device), None
        stream, need = self._demand_stream, packed_nbytes(groups)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            buf = self._demand_bufs[slot]
            if buf is None or buf.numel() < need:
                buf = self._demand_bufs[slot] = torch.empty(
                    need, dtype=torch.uint8, device=self.device)
            if self._demand_freed[slot] is not None:
                stream.wait_event(self._demand_freed[slot])
            if ready is not None:
                stream.wait_event(ready)
            dev, offset = [], 0
            for g in groups:
                leaves = tree_leaves(g)
                dev.append(_rebuild(g, iter(_pack(
                    leaves, self.device, True, buf, offset))))
                offset += sum(_aligned(t) for t in leaves)
            copied = torch.cuda.Event()
            copied.record(stream)
        return dev, copied

    def _free_demand_slot(self, st: _Staged, done):
        """``st``'s slot is free once ``done`` (None: no reader) has run on
        the card; the next queued entry is copied into it."""
        if st.slot is not None:
            if done is not None:
                self._demand_freed[st.slot] = done
            self._demand_free.append(st.slot)
            st.slot = None
        self._issue_demands()

    def _drop_demand(self, st: _Staged):
        st.tree = None
        if st.slot is None:       # still queued: never copied
            self._demand_q = deque(e for e in self._demand_q
                                   if e[1] is not st)
        self._free_demand_slot(st, None)

    # ------------------------------------------------------------ consume
    def acquire(self, name: str, timeout: Optional[float] = None):
        """Block until ``name``'s weights are staged; returns the device
        groups. The wait is the exposed copy time; the rest was hidden.
        With ``timeout``, a static entry not staged within it raises
        ``DemandTimeout``: the caller then ``abandon``s it (never
        releases) and fetches the shard itself. A demand entry has been
        copied (or its copy issued) once an entry before it freed a slot,
        and is never waited for here."""
        st = self._staged[name]
        if st.pool == "demand" and not st.event.is_set():
            raise AssertionError(f"{name} acquired before a demand slot "
                                 "freed for it: release each demanded "
                                 "entry before acquiring the next")
        t0 = time.perf_counter()
        staged = st.event.wait(timeout)
        exposed = time.perf_counter() - t0
        if not staged:
            raise DemandTimeout(f"{name} not staged within {timeout:.3f}s")
        if st.error is not None:
            raise st.error
        self.stats.copy_s_exposed += exposed
        self.stats.copy_s_hidden += max(st.copy_s - exposed, 0.0)
        return hand_to_compute(st.tree, st.copied, self.device)

    def release(self, name: str):
        """Free ``name``'s scratch slot. Compute for it has been issued and
        the caller holds no reference to its tree any more."""
        st = self._staged.pop(name)
        st.tree = None
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        if st.pool == "demand":
            self._free_demand_slot(st, done)
        else:
            self._free_slot(done)

    def discard(self, name: str):
        """Drop an entry whose error the consumer took from ``acquire``:
        its slot frees if a worker took one for it. The caller fetches the
        shard itself."""
        with self._lock:
            st = self._staged.pop(name)
            st.tree = None
            if st.pool == "static" and st.holds_slot:
                self._free_slot(None)
        if st.pool == "demand":
            self._drop_demand(st)

    def abandon(self, name: str):
        """Drop an entry the consumer will not acquire: its slot frees now
        if the copy has landed (a demand entry's always), else when it
        lands — once either way. The caller must not touch ``name`` again
        this pass."""
        with self._lock:
            st = self._staged.pop(name)
            st.abandoned = True
            self.stats.abandoned += 1
            if st.pool == "static" and st.event.is_set():
                st.tree = None
                self._free_slot(None)
        if st.pool == "demand":
            self._drop_demand(st)

    def finish(self):
        """End the session; joins the transfer thread."""
        if not self.active:
            return
        for pl, _ in self._demand_q:     # requested, never copied
            self._staged.pop(pl.sub.name)
        self._demand_q.clear()
        # unconsumed slots (error paths) must not deadlock the worker
        while self._staged:
            name = next(iter(self._staged))
            self._staged[name].event.wait()
            self.release(name)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._demand_free = None
        self._demand_bufs, self._demand_freed = [], []
