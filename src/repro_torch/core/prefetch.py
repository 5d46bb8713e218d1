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

The reference's demand pool (MoE experts, paged-KV restores), copy retries
and worker watchdog come with the MoE, paged-KV and faults slices.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_nbytes


@dataclass
class PrefetchStats:
    copy_s_hidden: float = 0.0   # copy time overlapped under compute
    copy_s_exposed: float = 0.0  # copy time the consumer actually waited
    staged_bytes: int = 0        # actual bytes moved host->device
    staged_sublayers: int = 0
    slots: int = 0               # realised double-buffer depth (0: no session)


class _Staged:
    __slots__ = ("event", "tree", "copy_s", "error", "copied")

    def __init__(self):
        self.event = threading.Event()   # set once the copy has landed
        self.tree = None
        self.copy_s = 0.0
        self.error: Optional[BaseException] = None
        self.copied = None               # CUDA event recorded after the copy


def stage_tree(tree, device, stream):
    """Copy a host tree to ``device`` on ``stream`` and wait for it on the
    calling thread only. Returns (device tree, CUDA event or None)."""
    if device.type != "cuda":
        return tree_map(lambda t: t.to(device), tree), None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev = tree_map(lambda t: t.to(device, non_blocking=True), tree)
        copied = torch.cuda.Event()
        copied.record(stream)
    copied.synchronize()
    return dev, copied


def hand_to_compute(tree, copied, device):
    """Order the current (compute) stream after a staged copy, and mark the
    staged tensors as used by it so their memory is not reused early."""
    if copied is None:
        return tree
    cur = torch.cuda.current_stream(device)
    cur.wait_event(copied)
    for t in tree_leaves(tree):
        t.record_stream(cur)
    return tree


class PrefetchEngine:
    """Background-thread transfer queue over a plan's streamed placements.

    ``fetch_host(sub)`` returns the host-resident (pinned) weight tree of a
    sub-layer; the engine copies it to ``device`` and hands the device tree
    to ``acquire`` in FIFO order.
    """

    def __init__(self, fetch_host: Callable, device: torch.device):
        self._fetch_host = fetch_host
        self.device = device
        self.stats = PrefetchStats()
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._thread: Optional[threading.Thread] = None
        self._staged: dict = {}
        self._sem: Optional[threading.Semaphore] = None
        # one CUDA event per released slot, recorded on the compute stream
        # after the slot's last reader; kept across sessions so the next
        # pass's first copies also wait for the previous pass's readers
        self._freed: deque = deque()

    @property
    def active(self) -> bool:
        """True while a staging session is running; a live re-plan
        (``PipelinedExecutor.rebind``) must wait for the pass to finish."""
        return self._thread is not None

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

    def start(self, order: List, avail_bytes: Optional[int] = None):
        """Begin staging ``order`` (Placement list) one sub-layer ahead.

        Every item of ``order`` MUST be acquire()d and release()d by the
        consumer in this exact sequence (or the session finish()ed early) —
        a skipped item would hold its scratch slot for the whole pass."""
        assert not self.active, "prefetch session already active"
        if not order:
            return
        names = [p.sub.name for p in order]
        assert len(set(names)) == len(names), "duplicate sub-layer in order"
        self.stats.slots = self.slots_for(order, avail_bytes)
        self._sem = threading.Semaphore(self.stats.slots)
        self._staged = {n: _Staged() for n in names}
        self._thread = threading.Thread(target=self._worker,
                                        args=(list(order),), daemon=True)
        self._thread.start()

    def _stage_one(self, pl, st: _Staged):
        try:
            t0 = time.perf_counter()
            host = self._fetch_host(pl.sub)
            st.tree, st.copied = stage_tree(host, self.device, self._stream)
            st.copy_s = time.perf_counter() - t0
            self.stats.staged_bytes += tree_nbytes(host)
            self.stats.staged_sublayers += 1
        except Exception as e:   # surfaced to the consumer on acquire
            st.error = e
        finally:
            st.event.set()

    def _worker(self, order):
        for pl in order:
            self._sem.acquire()
            if self._freed:
                self._freed.popleft().synchronize()
            self._stage_one(pl, self._staged[pl.sub.name])

    # ------------------------------------------------------------ consume
    def acquire(self, name: str):
        """Block until ``name``'s weights are staged; returns the device
        tree. The wait is the exposed copy time; the rest was hidden."""
        st = self._staged[name]
        t0 = time.perf_counter()
        st.event.wait()
        exposed = time.perf_counter() - t0
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
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._freed.append(done)
        self._sem.release()

    def finish(self):
        """End the session; joins the transfer thread."""
        if not self.active:
            return
        # unconsumed slots (error paths) must not deadlock the worker
        while self._staged:
            name = next(iter(self._staged))
            self._staged[name].event.wait()
            self.release(name)
        self._thread.join()
        self._thread = None
