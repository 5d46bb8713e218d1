"""What one step of the port costs, counted from its own dispatch.

The counterpart of what XLA's ``cost_analysis`` and ``memory_analysis``
give the reference's dry-run. The port runs eagerly, so the counts come
from the ops the step dispatches:

- ``flops``: the products, by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: 2 per
  multiply-add of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``);
- ``bytes_accessed``: each op's inputs read once and outputs written once,
  unfused, as XLA-CPU's "bytes accessed" is (a broadcast dim read once,
  ``distinct_bytes``); a view (an op whose outputs alias an input and
  that writes nothing) moves no bytes, and an op without a tensor output
  (a query) is not an op here;
- ``peak_live_bytes``: the most bytes of storage alive at once: the
  arguments' storages, and each storage an op makes from when it is made
  until it is freed (a weak reference to the storage says when);
- ``kernels``: each kernel wrapper (``"K1"``, ``"K2"``, ``"K3"``,
  ``"K4"`` and K4's backward ``"K4bwd"``, the names ``chip_smoke.py``
  uses) as one unit counted by hand, ``matmul_work``,
  ``flash_work`` and ``flash_bwd_work``: the work of the function, not of
  one implementation of it, so a later redesign of a kernel leaves its
  count as it is. A launch through ``ctypes`` is invisible to a dispatch
  mode, and no op inside a wrapper's plain version is counted, so a step
  counts the same on CPU tensors, on fake tensors and on the card. Inside
  a count a wrapper's temporaries (K1–K3's split-K workspace and tile
  counters, the f32 D scratch of K4's backward) are made as fake tensors
  that the live-bytes tracker sees; its outputs (K4's lse included) are
  tracked as any op's.

A count on fake tensors (``torch._subclasses.fake_tensor``: shapes,
dtypes and devices, no storage) allocates nothing, so a cell of any size
is counted on the host; ``count_step`` enters the arguments' fake mode
and fails if any op makes a real tensor. The same step on real tensors
counts the same integers. Collectives are 0 on one card.

    with count_step(params, batch, cache) as rec:
        out = step(params, batch, cache)
        rec.outputs(out)
    rec.flops, rec.bytes_accessed, rec.peak_live_bytes, rec.kernels

The peak data-sheet rates of the H100 SXM and the bounds that
``chip_smoke.py`` prints for each kernel are here too, so one source
serves both.
"""
from __future__ import annotations

import contextlib
import heapq
import weakref

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.device import is_fake

# H100 SXM data sheet: dense bf16 tensor rate, f32 rate outside the
# tensor cores, HBM3 bandwidth, device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12
CARD_BYTES = 80 * 10 ** 9
COLLECTIVES = {"total_traffic_bytes": 0, "by_kind": {}, "n_ops": 0,
               "note": "one card: no collectives (the reference counts its "
                       "16x16 mesh's from HLO; hlo_analysis.py has no "
                       "counterpart without HLO)"}


# ------------------------------------------------------------ hand counts
def matmul_work(M, K, N, dtype_bytes, w_bytes=None):
    """(operations, bytes) of (M, K) @ (K, N): 2MKN, and x read once, the
    weight read once (``w_bytes``: the stored codes, scales and zeros of
    a quantised weight; K N ``dtype_bytes`` by default) and y written
    once."""
    if w_bytes is None:
        w_bytes = K * N * dtype_bytes
    return 2 * M * K * N, (M * K + M * N) * dtype_bytes + w_bytes


def visible_pairs(Tq, Tk, causal):
    """Visible (query, key) pairs: min(i + 1, Tk) for row i when causal."""
    if causal:
        n = min(Tq, Tk)
        return n * (n + 1) // 2 + max(Tq - Tk, 0) * Tk
    return Tq * Tk


def flash_work(shape, causal, dtype_bytes, lse=False):
    """(operations, bytes) of one attention call, shape (B, H, KV, Tq, Tk,
    hd): 4 hd per visible (query, key) pair (two products), q, k, v read
    once and o written once (and the f32 lse, when asked for)."""
    B, H, KV, Tq, Tk, hd = shape
    byts = (2 * B * H * Tq + 2 * B * KV * Tk) * hd * dtype_bytes
    return (4 * B * H * hd * visible_pairs(Tq, Tk, causal),
            byts + (B * H * Tq * 4 if lse else 0))


def flash_bwd_work(shape, causal, dtype_bytes):
    """(operations, bytes) of K4's backward: 2.5 times the forward's
    operations (five products of 2 hd per visible pair: S and dP, dv, dk,
    dq), q, k, v, dO and the f32 lse read once and dq, dk, dv written
    once."""
    B, H, KV, Tq, Tk, hd = shape
    byts = ((3 * B * H * Tq + 4 * B * KV * Tk) * hd * dtype_bytes
            + B * H * Tq * 4)
    return 10 * B * H * hd * visible_pairs(Tq, Tk, causal), byts


def bound_ms(work, flops_peak):
    """Least ms for ``work`` (operations, bytes) on the card: the bytes
    over the HBM rate or the operations over ``flops_peak``, the larger,
    and which of the two it is (``"bytes"`` or ``"operations"``)."""
    ops, byts = work
    t_bytes = byts / PEAK_HBM_BPS * 1e3
    t_ops = ops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(t) -> int:
    """Bytes of a tensor's elements (of the view, not its storage)."""
    return t.numel() * t.element_size()


def distinct_bytes(t) -> int:
    """Bytes of a tensor's distinct elements: a broadcast (stride 0) dim
    is read once. So a product that autograd or a decomposition takes as a
    ``bmm`` over an expanded weight reads as many bytes as the same
    product folded into one ``mm``: which of the two the dispatcher takes
    can depend on the stride it gives a size-1 dim, which fake tensors
    and real ones may set differently."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


# ------------------------------------------------------------ the count
_ACTIVE = None        # the Count being taken, or None


def active():
    """The ``Count`` being taken, or None outside ``count_step``. A module
    global, not a thread-local: autograd runs a CUDA backward on a thread
    of its own, and the wrappers there count into the same record."""
    return _ACTIVE


# the caching allocator's grain: an allocation of n bytes takes n rounded
# up to 512 B, and a block it does not split may hold up to 512 B (1 MiB
# in the large pool, above 1 MiB) more
_SMALL = 2 ** 20


def _slack(n):
    """The most the CUDA caching allocator's ``allocated_bytes`` may add
    to an n-byte storage (see ``_SMALL``)."""
    if n == 0:
        return 0
    return 1023 if n <= _SMALL else _SMALL + 511


# ``torch.tensor(value)`` makes its tensor outside the dispatcher and then
# lifts it: a no-op on real tensors, a fake copy under a fake mode. A
# constant either way, like an op without a tensor output (a query: a fake
# tensor's device, a scalar), it is not an op of the step.
_CONSTANTS = (torch.ops.aten.lift_fresh.default,
              torch.ops.aten.lift_fresh_copy.default)


def _key(t):
    return t.untyped_storage()._cdata


class Count:
    """One step's counts (see the module docstring). ``kernels``: name ->
    ``{"units", "flops", "bytes"}``; ``peak_upper_bytes``: the peak with
    each non-argument storage's ``_slack`` added, the most the card's
    allocator may report above ``argument_bytes`` besides its own
    workspaces; ``peak_tags``: the bytes alive at the peak by the op (or
    kernel output, or ``"argument"``) that made them; ``peak_largest``:
    the largest storage alive at the peak that is not an argument, (bytes,
    tag)."""

    def __init__(self, fake: bool):
        self.fake = fake
        self.flops = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.kernels = {}
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self.live = 0
        self.peak_live_bytes = 0
        self.peak_upper_bytes = 0
        self.peak_tags = {}
        self.peak_largest = (0, None)
        self._slack_live = 0
        self._live = {}          # storage key -> (bytes, tag, serial)
        self._tag_live = {}      # tag -> bytes alive
        self._largest = []       # heap of (-bytes, serial, key, tag)
        self._serial = 0
        self._arg_keys = set()
        self._quiet = 0
        self._open = True
        self._fake_mode = None

    # ---------------- storages
    def _track(self, t, tag):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._serial += 1
        self._live[key] = (n, tag, self._serial)
        self._tag_live[tag] = self._tag_live.get(tag, 0) + n
        self.live += n
        if tag != "argument":
            self._slack_live += _slack(n)
            heapq.heappush(self._largest, (-n, self._serial, key, tag))
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        if not self._open or key not in self._live:
            return
        n, tag, _ = self._live.pop(key)
        self._tag_live[tag] -= n
        self.live -= n
        if tag != "argument":
            self._slack_live -= _slack(n)

    def _mark(self):
        """Update the peaks; at a new peak, the bytes alive by tag and the
        largest storage alive (the heap's freed entries dropped first),
        each in time independent of how many storages are alive."""
        if self.live > self.peak_live_bytes:
            self.peak_live_bytes = self.live
            self.peak_tags = {t: n for t, n in self._tag_live.items() if n}
            heap = self._largest
            while heap and self._live.get(heap[0][2], (0, 0, 0))[2] \
                    != heap[0][1]:
                heapq.heappop(heap)
            self.peak_largest = (-heap[0][0], heap[0][3]) if heap \
                else (0, None)
        self.peak_upper_bytes = max(self.peak_upper_bytes,
                                    self.live + self._slack_live)

    def _arguments(self, trees):
        seen = set()
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.argument_bytes += nbytes(t)
                self._arg_keys.add(_key(t))
                self._track(t, "argument")
        self._mark()

    def outputs(self, tree):
        """Record the step's outputs: ``output_bytes`` (each output
        tensor's bytes once) and ``alias_bytes`` (those of outputs that
        lie in an argument's storage: a cache written in place)."""
        seen = set()
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.output_bytes += nbytes(t)
                if _key(t) in self._arg_keys:
                    self.alias_bytes += nbytes(t)
        return tree

    # ---------------- ops
    def _op(self, func, args, kwargs, out):
        if self._quiet:
            return
        ins = {id(t): t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or func in _CONSTANTS:
            return
        if self.fake and not all(is_fake(t) for t in outs):
            raise AssertionError(f"a fake count made a real tensor: {func}")
        self.n_ops += 1
        in_keys = {_key(t) for t in ins.values()}
        aliasing = all(_key(t) in in_keys for t in outs)
        if not (func.is_view or (outs and aliasing
                                 and not func._schema.is_mutable)):
            self.bytes_accessed += sum(map(distinct_bytes, ins.values())) \
                + sum(map(distinct_bytes, outs))
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        tag = str(func._overloadpacket)
        for t in outs:
            if _key(t) not in in_keys:
                self._track(t, tag)
        self._mark()

    # ---------------- kernel units
    @contextlib.contextmanager
    def unit(self, name, work, temporaries=(), device=None):
        """One kernel wrapper's call, counted by hand: ``work``
        (operations, bytes) added to the totals and to ``kernels[name]``;
        no op dispatched inside counts or is tracked. The body makes the
        outputs (fake empties on fake inputs, the plain version on the
        CPU, the kernel on the card) and passes them to the yielded
        function, which tracks them and, while they are alive, the
        ``temporaries`` ((shape, dtype) each) as fake tensors on
        ``device``."""
        ops, byts = work
        k = self.kernels.setdefault(name, {"units": 0, "flops": 0,
                                           "bytes": 0})
        k["units"] += 1
        k["flops"] += ops
        k["bytes"] += byts
        self.flops += ops
        self.bytes_accessed += byts

        def done(*outs):
            temps = self._temporaries(temporaries, device)
            for t in outs:
                self._track(t, name)
            for t in temps:
                self._track(t, f"{name} temporary")
            self._mark()
            del temps
            return outs[0] if len(outs) == 1 else outs
        self._quiet += 1
        try:
            yield done
        finally:
            self._quiet -= 1

    def _temporaries(self, specs, device):
        if not specs:
            return []
        if self._fake_mode is None:
            self._fake_mode = FakeTensorMode()
        with self._fake_mode:
            return [torch.empty(shape, dtype=dtype, device=device)
                    for shape, dtype in specs]

    def as_dict(self):
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "peak_live_bytes": self.peak_live_bytes,
                "peak_upper_bytes": self.peak_upper_bytes,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "alias_bytes": self.alias_bytes, "n_ops": self.n_ops,
                "fake": self.fake,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_tags": dict(self.peak_tags),
                "peak_largest": list(self.peak_largest)}


class _Dispatch(TorchDispatchMode):
    """Hands every op and its outputs to the ``Count``."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec._op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def count_step(*arguments):
    """Count what runs inside: yields a ``Count``. ``arguments``: the
    step's inputs (trees of tensors), whose storages are alive from the
    start (``argument_bytes``). When they are fake tensors the count
    enters their fake mode, and fails if an op makes a real tensor. Call
    ``rec.outputs(out)`` on the step's result inside the block. Counts do
    not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("count_step does not nest")
    leaves = [t for t in tree_leaves(arguments) if isinstance(t, torch.Tensor)]
    mode = detect_fake_mode(leaves)
    rec = Count(fake=mode is not None)
    with contextlib.ExitStack() as stack:
        if mode is not None:
            stack.enter_context(mode)
        stack.enter_context(_Dispatch(rec))
        rec._arguments(arguments)
        _ACTIVE = rec
        try:
            yield rec
        finally:
            _ACTIVE = None
            rec._open = False


@contextlib.contextmanager
def constant():
    """A block whose ops make constants of the program (rope frequencies
    and the like), not work of the step: inside a count nothing in it is
    counted or tracked, so a cache that is warm on one run and cold on
    another counts the same."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    rec._quiet += 1
    try:
        yield
    finally:
        rec._quiet -= 1
