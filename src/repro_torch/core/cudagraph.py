"""CUDA graphs of the fused decode pass, and the host counts a replay
keeps.

A decode pass whose every sub-layer is pinned does the same host work on
every step: about 1,200 kernel launches for qwen3-14b at 10 layers,
issued one at a time by eager PyTorch while the card waits. The executor
records such a pass once per key and replays it
(``PipelinedExecutor.decode_fused``): the same kernels, with the same
launch configurations, in the same order, so the results are the same
bits.

PyTorch's own operations go into the graphs. The hand-written kernels
(K1, K2, K3: every FFN and Mamba-2 projection, ``engine._mm``) stay out
of them: each replay launches them through their Python wrappers, between
two graphs (``eager``), so the wrappers' launch counters, and whatever
wraps their entry points, see every call. A launch's output is copied
into a buffer of the recording, which the next graph reads.

``CudaGraphCapture`` is what the executor records through. A test puts a
stand-in of the same three methods in its place
(``PipelinedExecutor.graph_capture``) to drive the engage decision, the
keys and their invalidation on the CPU.

A replayed pass runs none of the executor's Python, so its counts of a
pass (``ExecStats``) are taken once from the eager pass that opens each
key (``mark`` / ``since``) and added again on each replay (``apply``);
the recording's own Python run counts nothing (``counts_discarded``).
After N steps the counts equal N eager steps'.
"""
from __future__ import annotations

import threading
import warnings
import weakref
from contextlib import contextmanager
from dataclasses import fields

import torch

# the recording this thread is making, if any (``eager``)
_local = threading.local()


def eager(launch, args, shape, dtype):
    """``launch(*args)``, a hand-written kernel's launch through its
    wrapper, whose output is a ``shape`` tensor of ``dtype`` on
    ``args[0]``'s device. While this thread records a pass
    (``CudaGraphCapture``), the graph being recorded ends where the launch
    stands and the next begins; the recording launches nothing, and every
    replay launches it between the two."""
    rec = getattr(_local, "recording", None)
    if rec is None:
        return launch(*args)
    return rec.launch(launch, args, shape, dtype)


class _Recording:
    """A pass as graphs with eager launches between them: ``steps``, run
    in order, replay it. ``new_graph()`` makes a graph that
    ``capture_begin(**begin)`` / ``capture_end()`` record and ``replay()``
    runs."""

    def __init__(self, new_graph, **begin):
        self.new_graph = new_graph
        self.begin_kw = begin
        self.steps = []
        # every graph, the empty ones too, lives as long as the recording:
        # each holds its pool
        self.graphs = []
        self.graph = None

    def begin(self):
        self.graph = self.new_graph()
        self.graphs.append(self.graph)
        self.graph.capture_begin(**self.begin_kw)

    def end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            graph.capture_end()
        # two launches with nothing between them leave an empty graph
        if not any("empty" in str(w.message) for w in said):
            self.steps.append(graph.replay)

    def launch(self, launch, args, shape, dtype):
        self.end()
        self.begin()
        out = torch.empty(shape, dtype=dtype, device=args[0].device)

        def step():
            out.copy_(launch(*args))
        self.steps.append(step)
        return out


class CudaGraphCapture:
    """Records on a side stream of its own into one memory pool that every
    live recording it made shares. Graphs sharing a pool may reuse each
    other's intermediates, so a replay's outputs hold only until the next
    replay of any of them: read them first. Once all its recordings are
    gone (a rebind drops them), PyTorch's allocator takes no new graph
    into their pool while any of its tensors lives, so the next recording
    starts a new pool."""

    def __init__(self):
        self._stream = None
        self._pool = None
        self._live = weakref.WeakSet()

    def supports(self, device) -> bool:
        return device.type == "cuda"

    def warm(self, device, fn):
        """``fn()`` run eagerly on the capture stream, ordered after the
        work queued before it and before the work queued after: it makes
        what a recording may not (the lazily built constants and
        handles). Returns ``fn``'s tensors."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        for t in out:
            t.record_stream(cur)
        return out

    def capture(self, device, fn):
        """Record ``fn`` (after a ``warm`` of it) as graphs, with the
        launches of ``eager`` between them. Returns the replay: a function
        that runs them in order on the current stream and returns ``fn``'s
        output tensors, which the last graph rewrites.

        cuBLAS keeps a workspace per stream for the life of the process.
        Its caches are cleared before the recording and after it, so the
        capture stream's workspace is made inside the pool, which the
        graphs hold and free with them, and none is left behind: a later
        session's peak does not carry it. PyTorch's own graph trees
        (``torch._inductor.cudagraph_trees``) clear them the same way; a
        session on another thread makes its workspace again at its next
        call."""
        if not self._live:
            self._pool = torch.cuda.graph_pool_handle()
        # thread_local: a call of another thread (a prefetch worker, the
        # gateway's) does not void the recording
        rec = _Recording(torch.cuda.CUDAGraph, pool=self._pool,
                         capture_error_mode="thread_local")
        # as torch.cuda.graph does: the cached blocks go back to the card
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.stream(self._stream):
                rec.begin()
                _local.recording = rec
                try:
                    out = fn()
                finally:
                    _local.recording = None
                    if rec.graph is not None:
                        rec.end()
        finally:
            torch._C._cuda_clearCublasWorkspaces()

        def replay():
            for step in rec.steps:
                step()
            return out
        self._live.add(replay)
        return replay


def _at(value):
    if isinstance(value, list):
        return len(value)
    if isinstance(value, dict):
        return dict(value)
    return value


def mark(stats):
    """Where the counts of ``stats`` stand: each field (a list by its
    length)."""
    return {f.name: _at(getattr(stats, f.name)) for f in fields(stats)}


def since(stats, at):
    """What the counts gained since ``mark`` gave ``at``: a list's new
    entries, a dict's and a number's growth. A flag that moved cannot be
    replayed, and raises."""
    grown = {}
    for name, was in at.items():
        now = getattr(stats, name)
        if isinstance(now, list):
            d = now[was:]
        elif isinstance(now, dict):
            d = {k: v - was.get(k, 0) for k, v in now.items()
                 if v != was.get(k, 0)}
        elif isinstance(now, bool):
            if now != was:
                raise ValueError(f"a replayed pass cannot move {name}")
            continue
        else:
            d = now - was
        if d:
            grown[name] = d
    return grown


def apply(stats, grown):
    """Add ``since``'s ``grown`` once more: one replayed pass."""
    for name, d in grown.items():
        now = getattr(stats, name)
        if isinstance(now, list):
            now.extend(d)
        elif isinstance(now, dict):
            for k, v in d.items():
                now[k] = now.get(k, 0) + v
        else:
            setattr(stats, name, now + d)


@contextmanager
def counts_discarded(owner):
    """A pass whose counts must not count (a recording's Python run):
    ``owner.stats`` is a fresh one meanwhile."""
    stats = owner.stats
    owner.stats = type(stats)()
    try:
        yield
    finally:
        owner.stats = stats
