"""Inference-phase executor (paper Step 3/4): run a planned schedule with
pipelined copy-compute, dense and MoE decoders with stacked or paged KV,
and hybrids of one mixer a layer (``cfg.layer_pattern``) with stacked KV.

Executes the model *sub-layer by sub-layer* following the Schedule's
per-tier plan: pinned sub-layers use weights placed on the device once;
streamed ones are staged by a background ``PrefetchEngine`` from pinned
host memory into a two-slot scratch double-buffer one sub-layer ahead of
compute, so sub-layer i+1's host->device copy hides under sub-layer i's
compute; CPU-assigned ones are copied synchronously at use and computed on
the device, as the reference simulates them. ``overlap=False`` is the
synchronous baseline: every streamed sub-layer is copied at use.

A patterned hybrid (nemotron-h) runs one sub-layer a layer: a Mamba-2
mixer, an MLP or an attention layer, each pinned, prefetched or copied at
use under the plan like any other. Its cache holds the attention layers'
KV and each Mamba-2 layer's per-slot conv and SSM state (``init_kv``);
decode advances every slot's state in one pass and keeps the inactive
slots' as they were, prefill carries a slot's state from chunk to chunk
(a padded tail leaves it untouched), and the serving layer zeroes a
slot's state when it admits a request (``reset_state``).

CUDA graphs (``decode_fused``, ``core/cudagraph.py``): the serving
loop's fused decode pass, where every sub-layer of its tier plan is pinned
and the cache is stacked and the model not MoE, is recorded once per
(tier, batch) and replayed on later steps; a replay issues the same
kernels in the same order, PyTorch's from CUDA graphs and K1–K3 from
their wrappers between them, and adds the host counts of one eager pass.
Prefill, verify, per-slot, paged, MoE and streamed passes run eagerly.

Under ``torch.profiler`` each sub-layer is a ``sub.attn`` / ``sub.ffn`` /
``sub.mamba`` span (none in a replayed pass, which runs none of the
executor's Python), each
host wait for weights a ``wait.weights`` span and each wait for a device
result (an MoE route, a paged pass's positions) a
``wait.device`` span (``core/trace.py``); ``ExecStats`` holds the byte
counts.

Embedding, final norm and unembedding live on the device for the whole run,
outside the planned budget, as in the reference.

Chunked prefill: the picked tier is the chunk size (paper: "T serves as the
optimal chunk size for chunked prefills").

MoE runs monolithic (one ``moe`` sub-layer per layer) or expert-granular
(a router shard and one shard per expert, ``schedule.expert_granular``):
each layer routes first, reads the selected experts on the host, requests
the cold ones from the prefetcher's demand pool, computes the pinned ones
while those copy, then acquires, computes and releases each cold expert in
turn, so at most the demand pool's slots hold cold experts on the card.
No (E, ...) weight stack is built on either path: a sub-layer's experts
are moved and kept as trees of their own (``mlp.split_experts``). The
ledger holds exactly: ``streamed_bytes`` is the passes' static plan bytes
plus ``demanded_expert_bytes`` plus ``demanded_page_bytes``.

Faults (``core/faults.py``): every pass entry fires ``alloc.device`` before
its first launch and its first KV write, so a pass that an injected
allocation failure aborts left nothing to undo and re-runs bit-identically
after the serving layer degrades. A streamed sub-layer whose acquire fails
(a stage copy past its retries, a dead worker, a demand deadline, the
injected ``demand.timeout``) is discarded or abandoned and fetched at use,
with its bytes in the ledger once. A dead worker past the recovery
policy's ``crash_tolerance`` trips the watchdog (``degraded_sync``): from
the next pass on the executor runs the synchronous ``overlap=False`` path,
with the same tokens. An error raised by CUDA itself is never recovered
from; it propagates (``prefetch.is_device_error``).

Paged KV (``kv_layout="paged"``, ``core/kvpaged.py``): each pass maps its
write blocks first, then each layer pins its pages and restores the ones
evicted to host memory before its attention step, through the prefetcher's
demand pool (one ``kv_page`` entry per layer, a group per block; at use
without overlap), so a page demand never sits ahead of an earlier MoE
layer's expert demands.
Admission prefill maps cached prefix blocks and prefills only the suffix.

Speculative verify (``_run_verify``): W = k+1 positions per slot in one
streamed pass. Attention advances as a wavefront of W decode steps, one per
window column; embedding, FFN / MoE and the head run over the (B, W)
window, each column bit-equal to a decode step's (the FFN's rows on K1–K3,
norms and head per column, ``core/engine.py``). ``rollback_kv`` undoes the
rejected suffix.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cudagraph
from repro_torch.core import engine as eng
from repro_torch.core import trace
from repro_torch.core.costmodel import Placement
from repro_torch.core.faults import (DemandTimeout, FaultPlan, RecoveryPolicy,
                                     WorkerLost)
from repro_torch.core.kvpaged import PAGE_SIZE, PagedKVCache
from repro_torch.core.planner import PINNED_COMPUTE_KINDS, Schedule
from repro_torch.core.prefetch import (PrefetchEngine, drop_traceback,
                                       groups_nbytes, groups_to_device,
                                       hand_to_compute, is_device_error,
                                       stage_groups)
from repro_torch.core.sublayer import SubLayer
from repro_torch.device import resolve_device
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import greedy_token, tree_map
from repro_torch.models.hybrid import pattern_index, pattern_layers
from repro_torch.models.transformer import init_cache, layer_slice


@dataclass
class ExecStats:
    streamed_bytes: int = 0      # plan-accounted streamed weight bytes
    # the same bytes split by the shard's storage format (SubLayer
    # meta["quant"]: "fp16", "int8" or "int4"; attention is always "fp16")
    streamed_bytes_by_dtype: dict = field(default_factory=dict)
    at_use_bytes: int = 0        # non-streamed (CPU-engine) at-use fetches
    staged_bytes: int = 0        # actual host->device bytes moved
    prefetch_slots: int = 0      # realised scratch double-buffer depth
    boundary_hops: int = 0
    engine_calls: dict = field(default_factory=lambda: {"gpu": 0, "cpu": 0})
    tiers_used: list = field(default_factory=list)
    # per _run_decode pass: one pass == one serving iteration in fused mode,
    # one pass per active slot in the per-slot baseline
    decode_passes: int = 0
    pass_streamed_bytes: list = field(default_factory=list)
    # prefill loop order: layer-major runs ONE plan pass per prompt,
    # chunk-major one pass per chunk; one dict per prefill() call
    prefill_passes: int = 0
    prefill_stats: list = field(default_factory=list)
    # live re-plan swaps (rebind): only the pin/evict deltas between the
    # old and new schedules move; these match Schedule.diff byte for byte
    rebinds: int = 0
    rebind_pinned_bytes: int = 0
    rebind_evicted_bytes: int = 0
    rebind_s: float = 0.0
    # expert-granular MoE: distinct experts the routers selected per layer
    # and pass, how many of those were pinned (hits), the bytes of the
    # cold ones streamed on demand, and the pinned expert bytes now.
    # streamed_bytes == the passes' static plan bytes +
    # demanded_expert_bytes, always.
    expert_demanded: int = 0
    expert_hits: int = 0
    demanded_expert_bytes: int = 0
    resident_expert_bytes: int = 0
    pass_expert_stats: list = field(default_factory=list)
    # the most rows per expert of the (E, C, d) dispatch and output
    # buffers held at once: one chunk's capacity, or the sum over a
    # layer's chunks under expert-granular layer-major prefill
    moe_rows_peak: int = 0
    # paged-KV block restores: the second demand-streamed shard kind beside
    # cold experts ("kv" bucket in streamed_bytes_by_dtype)
    page_faults: int = 0
    demanded_page_bytes: int = 0
    # speculative decoding: drafted = draft tokens offered to verify
    # passes, accepted = drafted tokens the target confirmed (the bonus
    # token from the target's own argmax is not counted), rollbacks =
    # slots whose rejected KV suffix was rolled back
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rollbacks: int = 0
    spec_rolled_back_tokens: int = 0
    spec_verify_passes: int = 0
    # per verify pass: the streamed / static / expert / page byte split of
    # the ledger streamed == static + experts + pages
    verify_pass_stats: list = field(default_factory=list)
    # fault recovery: retries and failures mirror the prefetcher's; a sync
    # fallback is a shard fetched at use after its stage failed, its
    # worker died or its deadline passed; degraded_sync is set once the
    # worker watchdog parks the executor on the overlap=False path
    fault_copy_retries: int = 0
    fault_copy_failures: int = 0
    fault_worker_crashes: int = 0
    fault_demand_timeouts: int = 0
    fault_sync_fallbacks: int = 0
    fault_alloc_failures: int = 0
    degraded_sync: bool = False
    # patterned hybrids: the Mamba-2 layers' conv and SSM state on the
    # device (``init_kv``), and the slots zeroed for an admission
    ssm_state_bytes: int = 0
    state_resets: int = 0
    # fused decode passes captured as CUDA graphs (one per key, and again
    # after a rebind or on another cache) and replayed (``decode_fused``)
    decode_graph_captures: int = 0
    decode_graph_replays: int = 0

    @property
    def accept_rate(self) -> float:
        return self.spec_accepted / max(self.spec_drafted, 1)

    @property
    def expert_hit_rate(self) -> float:
        return self.expert_hits / max(self.expert_demanded, 1)


def resolve_prefill_mode(prefill_mode) -> str:
    """``None`` -> the default, layer-major."""
    return "layer_major" if prefill_mode is None else prefill_mode


@dataclass
class _Graph:
    """A recorded fused decode pass: what it was recorded against, its
    static inputs (tokens, positions, active mask), the replay, and the
    ``ExecStats`` counts of one pass (``cudagraph.since``)."""
    stamp: tuple
    inputs: tuple
    replay: object
    counts: dict


def pin_host_tree(tree, device):
    """Host copies of the weights for ``device``: page-locked when the
    device is a CUDA card, so ``non_blocking`` copies really overlap."""
    if device.type != "cuda":
        return tree
    return tree_map(lambda t: t if t.is_pinned() else t.pin_memory(), tree)


class PipelinedExecutor:
    """Dense / MoE decoder and patterned-hybrid executor under a
    pipelined-sharding schedule."""

    def __init__(self, cfg, params, schedule: Schedule, max_seq: int = 512,
                 overlap: bool = True, prefill_mode: str | None = None,
                 kv_layout: str = "stacked",
                 kv_page_size: int | None = None,
                 kv_pool_pages: int | None = None, device=None,
                 faults: FaultPlan | None = None,
                 recovery: RecoveryPolicy | None = None):
        if cfg.family not in ("dense", "moe") and not cfg.layer_pattern:
            raise NotImplementedError(
                f"the port's executor runs dense and MoE decoders and "
                f"hybrids of one mixer a layer, not family={cfg.family!r}")
        if kv_layout not in ("stacked", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.schedule = schedule
        self.max_seq = max_seq
        self.kv_layout = kv_layout
        self.kv_page_size = kv_page_size or PAGE_SIZE
        self.kv_pool_pages = kv_pool_pages   # usable pages; None -> ample
        self._active_kvcache = None          # paged cache of the live pass
        prefill_mode = resolve_prefill_mode(prefill_mode)
        if prefill_mode not in ("layer_major", "chunk_major"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.prefill_mode = prefill_mode
        # live queue-pressure hints, set by the serving layer before a
        # pass; the defaults leave every tier pick queue-blind
        self.sched_queue_depth = 0
        self.sched_slack_s: float | None = None
        self.stats = ExecStats()
        # fault injection (None: every check is one skipped branch) and
        # the always-on recovery policy
        self.faults = faults
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        self._sync_staged = 0
        # split params into per-sublayer host copies ("sysRAM"), pinned
        host = pin_host_tree(params, self.device)
        self.host = {k: host[k] for k in ("embed", "final_norm", "unembed")
                     if k in host}
        # each layer's index into its kind's stacks (weights, KV, state)
        if cfg.layer_pattern:
            self.layer_params = pattern_layers(host["layers"],
                                               cfg.layer_pattern)
            self._index = pattern_index(cfg.layer_pattern)
        else:
            self.layer_params = [layer_slice(host["layers"], i)
                                 for i in range(cfg.n_layers)]
            self._index = list(range(cfg.n_layers))
        # embed / final norm / output head live once on device (the paper
        # pins outputs last)
        self._embed_dev = self.host["embed"].to(self.device)
        self._final_dev = self.host["final_norm"].to(self.device)
        self._unembed_dev = (self._embed_dev.T if cfg.tie_embeddings
                             else self.host["unembed"].to(self.device))
        # pin once per schedule; the canonical pin set comes from the
        # schedule itself so rebind() and Schedule.diff stay in agreement
        self._pinned = {}
        self._pinned_bytes = {}
        self._pinned_kinds = {}
        for pl in schedule.pinned_placements():
            self._pin(pl)
        self._pinned_names = set(self._pinned)
        self.expert_granular = schedule.expert_granular
        self._demand_active = False
        self._layer_demanded: list = []  # distinct experts per MoE layer
        self.expert_ema: dict = {}       # layer -> (E,) routing freqs
        self.ema_alpha = 0.25
        self._refresh_resident_expert_bytes()
        # at-use copies get their own stream, so the host waits for the
        # copy alone and not for the compute queued before it
        self._sync_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._at_use_done = None   # CUDA event after the last at-use reader
        self.prefetch = PrefetchEngine(
            self._host_groups, self.device, faults=faults,
            recovery=self.recovery) if overlap else None
        # fused decode passes as CUDA graphs: (tier, batch) -> _Graph
        self.graph_capture = cudagraph.CudaGraphCapture()
        self._graphs = {}

    def _pin(self, pl):
        self._pinned[pl.sub.name] = self._join(
            groups_to_device(self._subtree(pl.sub), self.device))
        self._pinned_bytes[pl.sub.name] = pl.sub.weight_bytes
        self._pinned_kinds[pl.sub.name] = pl.sub.kind

    def _refresh_resident_expert_bytes(self):
        self.stats.resident_expert_bytes = sum(
            self._pinned_bytes[n] for n, k in self._pinned_kinds.items()
            if k == "moe_expert")

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ rebind
    def rebind(self, schedule: Schedule) -> dict:
        """Swap in a re-planned schedule live.

        Applies only the pin/evict delta between the bound and the new
        schedule: sub-layers leaving the pinned set drop their device
        tensors, entering ones are copied once — the unchanged intersection
        is never touched and the KV caches (owned by the caller) survive,
        so in-flight decode slots keep their state. Every decode graph is
        dropped: the next fused pass at a key captures it again. Must be
        called between passes. Returns a report whose
        ``pinned_bytes``/``evicted_bytes`` equal the corresponding
        ``Schedule.diff`` fields."""
        assert self.prefetch is None or not self.prefetch.active, \
            "rebind during an active prefetch session (mid-pass)"
        t0 = time.perf_counter()
        # a graph holds the addresses of the weights it read
        self._graphs.clear()
        new_pins = {pl.sub.name: pl for pl in schedule.pinned_placements()}
        to_evict = [n for n in self._pinned if n not in new_pins]
        to_pin = [n for n in new_pins if n not in self._pinned]
        evicted_bytes = 0
        for name in to_evict:
            del self._pinned[name]
            del self._pinned_kinds[name]
            evicted_bytes += self._pinned_bytes.pop(name)
        pinned_bytes = 0
        for name in to_pin:
            self._pin(new_pins[name])
            pinned_bytes += new_pins[name].sub.weight_bytes
        sp = trace.begin("wait.device")
        self._synchronize()
        if sp is not None:
            trace.end(sp, what="rebind")
        self.schedule = schedule
        self._pinned_names = set(self._pinned)
        self._refresh_resident_expert_bytes()
        dt = time.perf_counter() - t0
        self.stats.rebinds += 1
        self.stats.rebind_pinned_bytes += pinned_bytes
        self.stats.rebind_evicted_bytes += evicted_bytes
        self.stats.rebind_s += dt
        return {"to_pin": to_pin, "to_evict": to_evict,
                "pinned_bytes": pinned_bytes,
                "evicted_bytes": evicted_bytes, "seconds": dt}

    # ------------------------------------------------------------ weights
    def _account_streamed(self, placement):
        """Single accounting point for plan-priced streamed bytes."""
        wb = placement.sub.weight_bytes
        q = placement.sub.meta.get("quant", "fp16")
        self.stats.streamed_bytes += wb
        self.stats.streamed_bytes_by_dtype[q] = \
            self.stats.streamed_bytes_by_dtype.get(q, 0) + wb

    def _subtree(self, sub):
        """A sub-layer's host weights as a list of trees, each moved to
        the card as one allocation (``prefetch.groups_to_device``): one
        tree, or for a whole MoE sub-layer its router and norm, then each
        expert's leaves (views of the stacks), so no copy of it to the
        card makes an (E, ...) stack. ``_join`` gives the tree a step
        takes."""
        lp = self.layer_params[sub.layer]
        if sub.kind == "attn":
            return [{"attn": lp["attn"], "ln1": lp["ln1"]}]
        if sub.kind == "mamba":
            return [{"mamba": lp["mamba"], "ln": lp["ln"]}]
        if sub.kind in ("ffn", "moe"):
            if "moe" in lp:
                experts = mlp_mod.split_experts(lp["moe"])["experts"]
                return [{"router": lp["moe"]["router"], "ln2": lp["ln2"]}] \
                    + [experts[e] for e in range(len(experts))]
            return [{"ffn": lp["ffn"], "ln2": lp["ln2"]}]
        if sub.kind == "moe_router":
            return [{"router": lp["moe"]["router"], "ln2": lp["ln2"]}]
        if sub.kind == "moe_expert":
            return [mlp_mod.expert_tree(lp["moe"], sub.meta["expert"])]
        raise ValueError(sub.kind)

    def _host_groups(self, sub):
        """``_subtree``, and for a ``kv_page`` shard the evicted blocks'
        host copies, a ``{"k", "v"}`` group per block, resolved against the
        live pass's paged cache."""
        if sub.kind == "kv_page":
            cache = self._active_kvcache
            assert cache is not None, "kv_page fetch outside a paged pass"
            return [cache.host_tree(bid) for bid in sub.meta["bids"]]
        return self._subtree(sub)

    @staticmethod
    def _join(groups):
        """The weight tree a step takes, from ``_subtree``'s groups on the
        card: a single tree as it is; a whole MoE sub-layer's as
        ``{"moe": {"router", "experts": {e: tree}}, "ln2"}``."""
        if len(groups) == 1:
            return groups[0]
        head = groups[0]
        return {"moe": {"router": head["router"],
                        "experts": dict(enumerate(groups[1:]))},
                "ln2": head["ln2"]}

    def _fetch_sync(self, placement):
        """Synchronous at-use transfer (CPU-engine placements, and every
        streamed placement when overlap is disabled). The previous at-use
        tree's compute must have run first, so at most one at-use sub-layer
        is on the device however far the host runs ahead."""
        return self._join(self._stage_sync(placement))

    def _stage_sync(self, placement, account: bool = True):
        """``_fetch_sync``'s transfer: the device groups, not joined.
        ``account=False`` is the recovery fetch of a shard whose plan
        bytes the caller counts itself: it moves the bytes and counts
        them staged, nowhere else. While tracing, the whole of it (the wait
        for the previous at-use reader and the copy) is a ``wait.weights``
        span with ``how="at_use"``, the copy a ``copy.h2d`` span."""
        wait = trace.begin("wait.weights")
        if self._at_use_done is not None:
            self._at_use_done.synchronize()
            self._at_use_done = None
        groups = self._host_groups(placement.sub)
        nbytes = groups_nbytes(groups)
        copy = trace.begin("copy.h2d")
        dev, copied = stage_groups(groups, self.device, self._sync_stream,
                                   ready=placement.sub.meta.get("ready"),
                                   span=copy)
        if copy is not None:
            trace.end(copy, sub=placement.sub.name, pool="at_use",
                      bytes=nbytes)
        if wait is not None:
            trace.end(wait, sub=placement.sub.name, how="at_use",
                      bytes=nbytes)
        self._sync_staged += nbytes
        if account and placement.streamed and placement.engine == "gpu":
            self._account_streamed(placement)
        elif account:
            self.stats.at_use_bytes += nbytes
        return hand_to_compute(dev, copied, self.device)

    def _weights_for(self, placement, streaming: set):
        """Returns (device tree, source): "pinned", "streamed" or
        "at_use". Hand the source to ``_done_with`` once the sub-layer's
        compute is issued and the tree is dropped."""
        name = placement.sub.name
        if name in self._pinned_names:
            return self._pinned[name], "pinned"
        if name in streaming:
            # counted before the acquire: the recovery fetch below moves
            # the bytes without counting them again
            self._account_streamed(placement)
            try:
                return self._join(self.prefetch.acquire(name)), "streamed"
            except Exception as e:
                if is_device_error(e):
                    raise
                drop_traceback(e)
                self._note_stream_fault(e)
                # the failed entry's slot frees now (if it held one), so
                # the rest of the pass's staging goes on
                self.prefetch.discard(name)
                groups = self._stage_sync(placement, account=False)
                return self._join(groups), "at_use"
        return self._fetch_sync(placement), "at_use"

    # ------------------------------------------------------------ recovery
    def _note_stream_fault(self, exc: Exception):
        """Count one recovery fetch, and trip the worker watchdog once the
        dead workers reach the policy's crash tolerance."""
        self.stats.fault_sync_fallbacks += 1
        if isinstance(exc, DemandTimeout):
            self.stats.fault_demand_timeouts += 1
        if isinstance(exc, WorkerLost) and not self.stats.degraded_sync \
                and self.prefetch.stats.worker_crashes \
                >= self.recovery.crash_tolerance:
            # every later acquire of the dead pool would fail too: from the
            # next pass on run the overlap=False path (same tokens)
            self.stats.degraded_sync = True

    def _demand_acquire(self, pl):
        """Acquire a demand entry under the demand deadline. Returns
        (device groups, source for ``_done_with``): on a timeout the entry
        is abandoned, on a failure discarded, and either way the shard is
        fetched at use, so a pass never waits on a demand it cannot get.
        The caller counts the plan bytes, once, whichever way came."""
        name = pl.sub.name
        try:
            if self.faults is not None:
                self.faults.check("demand.timeout", key=name)
            return self.prefetch.acquire(
                name, timeout=self.recovery.demand_deadline_s), "streamed"
        except Exception as e:
            # a device error, or the consumer's own ordering bug
            if is_device_error(e) or isinstance(e, AssertionError):
                raise
            drop_traceback(e)
            if isinstance(e, DemandTimeout):
                self.prefetch.abandon(name)
            else:
                self.prefetch.discard(name)
            self._note_stream_fault(e)
            return self._stage_sync(pl, account=False), "at_use"

    def _check_alloc(self, where: str):
        """The ``alloc.device`` point at a pass entry: before the pass's
        first launch and its first KV write, so the serving layer can
        degrade a rung and re-run the pass."""
        if self.faults is not None:
            try:
                self.faults.check("alloc.device", key=where)
            except Exception:
                self.stats.fault_alloc_failures += 1
                raise

    def _done_with(self, placement, source: str):
        """The sub-layer's compute is issued and its tree dropped: free the
        scratch slot, or mark where the at-use tree's readers end."""
        if source == "streamed":
            self.prefetch.release(placement.sub.name)
        elif source == "at_use" and self.device.type == "cuda":
            self._at_use_done = torch.cuda.Event()
            self._at_use_done.record(torch.cuda.current_stream(self.device))

    def _sync_stats(self):
        self.stats.staged_bytes = self._sync_staged
        if self.prefetch is not None:
            ps = self.prefetch.stats
            self.stats.staged_bytes += ps.staged_bytes
            self.stats.prefetch_slots = ps.slots
            self.stats.fault_copy_retries = ps.copy_retries
            self.stats.fault_copy_failures = ps.copy_failures
            self.stats.fault_worker_crashes = ps.worker_crashes

    # ------------------------------------------------------------ paged kv
    def _page_placement(self, cache, layer: int, bids):
        """Demand-only placement restoring ``bids``, one layer's evicted KV
        blocks, as one entry of a ``{"k", "v"}`` group per block. Never
        part of a plan (``kv_page`` is not a streamable kind): restores
        ride the same demand pool, acquire / release protocol and
        streamed-bytes ledger as cold experts, bucketed as "kv".
        ``meta["ready"]`` is the blocks' last write-back event, which the
        copy to the card waits for."""
        sub = SubLayer(name=f"kvpage/L{layer}", kind="kv_page", layer=layer,
                       weight_bytes=len(bids) * cache.block_bytes,
                       meta={"quant": "kv", "bids": list(bids),
                             "ready": cache.host_ready(bids)})
        return Placement(sub=sub, residency="sysram", engine="gpu",
                         streamed=True)

    def _page_fault_layer(self, cache, layer: int, page_stream: bool):
        """Restore this layer's evicted KV blocks before its attention
        step, as one demand entry folded into the pools at once. Requests
        go out per layer, not per pass: a pass-wide sweep would queue later
        layers' pages ahead of an earlier MoE layer's expert demands."""
        faults = cache.begin_layer(layer)
        if not faults:
            return
        pl = self._page_placement(cache, layer, faults)
        if page_stream:
            self.prefetch.request([pl])
            groups, src = self._demand_acquire(pl)
            self._account_streamed(pl)
            cache.fold(faults, groups)
            del groups
            self._done_with(pl, src)
        else:
            # at-use restore: overlap disabled, or a straggler evicted
            # after this pass's demand sizing; _stage_sync accounts the
            # streamed bytes
            cache.fold(faults, self._stage_sync(pl))
            self._done_with(pl, "at_use")
        self.stats.page_faults += len(faults)
        self.stats.demanded_page_bytes += len(faults) * cache.block_bytes

    def _prepare_pages(self, kv, pos_vec, active, width: int) -> int:
        """Map a decode (``width`` 1) or verify pass's write blocks and
        bind the cache to the pass. Returns the demand bytes its restores
        need: the most evicted blocks of one layer, or 0."""
        pos_h = trace.to_host(pos_vec, "pages")
        act_h = trace.to_host(active, "pages")
        faults = kv.prepare_verify({s: int(pos_h[s]) for s in
                                    range(len(act_h)) if act_h[s]}, width)
        self._active_kvcache = kv
        return kv.layer_fault_bytes(faults)

    # ------------------------------------------------------------ passes
    def _begin_pass(self, tier: int, page_demand_bytes: int = 0):
        """Start one pass at ``tier``: begin the prefetch session over the
        tier plan's streamed placements and return ``(by_name, streaming,
        started)``. Scratch sizing is read from the bound schedule's
        TierEntry each pass, so a live ``rebind`` re-sizes the next
        session's staging budget automatically. ``page_demand_bytes``
        joins the demand-slot sizing when the pass expects paged-KV
        restores."""
        entry = self.schedule.tiers[tier]
        plan = entry.plan
        self.stats.tiers_used.append(tier)
        by_name = {p.sub.name: p for p in plan.placements}
        # a sub-layer this executor pinned (canonical min-tier set) may be
        # marked streamed in the picked tier's plan; it must not enter the
        # prefetch queue or its scratch slot would never be released.
        # Expert shards never enter the static queue: they are requested
        # mid-pass, once each layer's router has selected them.
        order, demand_bytes = [], 0
        # once the watchdog tripped, every pass runs the overlap=False path
        if self.prefetch is not None and not self.stats.degraded_sync:
            order = [p for p in plan.static_stream_order()
                     if p.sub.name not in self._pinned_names]
            demand_bytes = max(
                (p.sub.weight_bytes for p in plan.streamed_expert_placements()
                 if p.sub.name not in self._pinned_names), default=0)
            demand_bytes = max(demand_bytes, page_demand_bytes)
        streaming = {p.sub.name for p in order}
        started = bool(order) or demand_bytes > 0
        self._demand_active = False
        if started:
            self.prefetch.start(order, avail_bytes=max(
                entry.scratch_bytes - entry.act_bytes, 0),
                demand_bytes=demand_bytes)
            self._demand_active = demand_bytes > 0
        return by_name, streaming, started

    def _end_pass(self, started: bool):
        if started:
            self.prefetch.finish()
        self._sync_stats()

    def _note_engine(self, placement, prev_engine, calls=1):
        self.stats.engine_calls[placement.engine] += calls
        if prev_engine is not None and prev_engine != placement.engine:
            self.stats.boundary_hops += 1
        return placement.engine

    def _ffn_sub(self, i, xs, valid, by_name, streaming, prev_engine,
                 cols=False):
        """Layer ``i``'s FFN sub-layer for the chunks ``xs`` (``valid``:
        each chunk's valid length, or None for no mask; ``cols``: norms
        per column, a verify window). Returns (xs, engine). While tracing,
        a ``sub.ffn`` span with the weights' source (expert-granular: the
        router's)."""
        sp = trace.begin("sub.ffn")
        cfg = self.cfg
        if self.expert_granular:
            pf = by_name[f"L{i}/moe.router"]
            if prev_engine is not None and prev_engine != pf.engine:
                self.stats.boundary_hops += 1
            xs, src = self._moe_granular(i, xs, valid, by_name, streaming,
                                         cols)
            prev_engine = pf.engine
        else:
            pf = by_name[f"L{i}/moe" if cfg.moe is not None
                         else f"L{i}/ffn"]
            w, src = self._weights_for(pf, streaming)
            prev_engine = self._note_engine(pf, prev_engine, calls=len(xs))
            if cfg.moe is None:
                xs = [eng.ffn_step(cfg, w, x, cols) for x in xs]
            else:
                self._note_moe_rows(max(mlp_mod.capacity_of(
                    x.shape[0] * x.shape[1], cfg.moe) for x in xs))
                if valid is None:
                    xs = [eng.moe_step(cfg, w, x, cols) for x in xs]
                else:
                    xs = [eng.moe_prefill_step(cfg, w, x, vl)
                          for x, vl in zip(xs, valid)]
            del w
            self._done_with(pf, src)
        if sp is not None:
            trace.end(sp, layer=i, source=src)
        return xs, prev_engine

    def _mixer_sub(self, i, kind, x, step, by_name, streaming, prev_engine,
                   calls=1):
        """Layer ``i``'s ``attn`` or ``mamba`` sub-layer: fetch its weights
        (pinned / prefetched / at-use), run ``step(w, x, j)`` with ``j``
        the layer's index into its kind's KV or state, release them.
        Returns (x, engine). While tracing, a ``sub.<kind>`` span with the
        weights' source."""
        sp = trace.begin("sub." + kind)
        pl = by_name[f"L{i}/{kind}"]
        w, src = self._weights_for(pl, streaming)
        prev_engine = self._note_engine(pl, prev_engine, calls=calls)
        x = step(w, x, self._index[i])
        del w
        self._done_with(pl, src)
        if sp is not None:
            trace.end(sp, layer=i, source=src)
        return x, prev_engine

    def _kinds(self, i):
        """(attention, FFN, Mamba-2) sub-layers of layer ``i``: both of
        the first in a decoder, one of the three in a patterned hybrid."""
        k = self.cfg.layer_pattern[i] if self.cfg.layer_pattern else None
        return k in (None, "*"), k in (None, "-"), k == "M"

    def _layer_loop(self, x, by_name, streaming, attn_fn, cols=False,
                    mamba_fn=None):
        """Walk every layer's (attn, ffn or moe, or mamba) sub-layers under
        the current pass's plan: fetch weights (pinned / prefetched /
        at-use), account engine calls and boundary hops, run the sub-layer,
        release scratch slots. ``attn_fn(w, x, j)`` and ``mamba_fn(w, x,
        j)`` supply the attention and Mamba-2 steps (``j``: the layer's
        index into the KV or the state); ``cols`` goes to the FFN
        sub-layer."""
        prev_engine = None
        for i in range(self.cfg.n_layers):
            attn, ffn, mamba = self._kinds(i)
            if mamba:
                x, prev_engine = self._mixer_sub(i, "mamba", x, mamba_fn,
                                                 by_name, streaming,
                                                 prev_engine)
            if attn:
                x, prev_engine = self._mixer_sub(i, "attn", x, attn_fn,
                                                 by_name, streaming,
                                                 prev_engine)
            if ffn:
                (x,), prev_engine = self._ffn_sub(i, [x], None, by_name,
                                                  streaming, prev_engine,
                                                  cols)
        return x

    # ------------------------------------------------ expert-granular moe
    def _note_moe_rows(self, rows):
        self.stats.moe_rows_peak = max(self.stats.moe_rows_peak, rows)

    def _record_routing(self, layer, idx_host):
        """EMA of the router's selection frequencies: the online refinement
        of the profile-DB routing stats the planner pins hot experts
        from."""
        E = self.cfg.moe.n_experts
        counts = np.bincount(idx_host.reshape(-1),
                             minlength=E).astype(np.float64)
        freq = counts / max(counts.sum(), 1.0)
        prev = self.expert_ema.get(layer)
        self.expert_ema[layer] = freq if prev is None else \
            (1 - self.ema_alpha) * prev + self.ema_alpha * freq

    def _demand_cold_experts(self, layer, demanded, by_name):
        """Split the demanded expert ids of ``layer`` into pinned hits and
        cold shards, count them, and request the streamable cold shards
        from the demand pool BEFORE the pinned experts compute, so their
        copies run under that compute. Returns (cold, streamed_cold)."""
        cold = []
        for e in demanded:
            name = f"L{layer}/moe.expert{e}"
            if name in self._pinned_names:
                self.stats.expert_hits += 1
            else:
                cold.append(by_name[name])
        self.stats.expert_demanded += len(demanded)
        self._layer_demanded.append(len(demanded))
        streamed_cold = [pl for pl in cold if self._demand_active
                         and pl.streamed and pl.engine == "gpu"]
        if streamed_cold:
            self.prefetch.request(streamed_cold)
        return cold, streamed_cold

    def _compute_cold_experts(self, cold, streamed_cold, jobs):
        """Acquire each demanded cold expert in turn, compute it for every
        job ``(routed ids, disp, out_buf)`` that routed to it, and release
        it before the next acquire: at most the demand pool's slots hold
        cold experts on the card. Streamed bytes are counted here once per
        expert and pass."""
        requested = {pl.sub.name for pl in streamed_cold}
        for pl in cold:
            e = pl.sub.meta["expert"]
            self.stats.engine_calls[pl.engine] += 1
            if pl.sub.name in requested:
                groups, src = self._demand_acquire(pl)
                tree = self._join(groups)
                del groups
                self._account_streamed(pl)
                self.stats.demanded_expert_bytes += pl.sub.weight_bytes
            else:
                # at-use transfer (overlap off, or a CPU-engine placement);
                # _fetch_sync counts it as streamed or at-use
                tree = self._fetch_sync(pl)
                src = "at_use"
                if pl.streamed and pl.engine == "gpu":
                    self.stats.demanded_expert_bytes += pl.sub.weight_bytes
            for ids, disp, out_buf in jobs:
                if e in ids:
                    eng.moe_experts_step([(e, tree)], disp, out_buf)
            del tree
            self._done_with(pl, src)

    def _moe_granular(self, layer, xs, valid, by_name, streaming,
                      cols=False):
        """One expert-granular MoE sub-layer over the chunks ``xs``: route
        every chunk, then demand the union of the routed cold experts
        once, so under layer-major prefill each cold expert crosses the
        link once per prompt and computes every chunk's rows while it is
        resident. The pinned experts compute first, each chunk's routed
        ones, while the cold copies fly. Padded positions (``valid``) carry
        the id E and enter neither the demanded set nor the EMA. Returns
        (xs, the router's source)."""
        E = self.cfg.moe.n_experts
        r_pl = by_name[f"L{layer}/moe.router"]
        w_r, src = self._weights_for(r_pl, streaming)
        self.stats.engine_calls[r_pl.engine] += len(xs)
        jobs, routed_aux, union = [], [], set()
        for c, x in enumerate(xs):
            if valid is None:
                disp, aux, idx = eng.moe_route_step(self.cfg, w_r, x, cols)
            else:
                disp, aux, idx = eng.moe_route_prefill_step(
                    self.cfg, w_r, x, valid[c])
            idx_host = trace.to_host(idx, "route")
            idx_host = idx_host[idx_host < E]
            self._record_routing(layer, idx_host)
            ids = {int(e) for e in np.unique(idx_host)}
            union |= ids
            jobs.append((ids, disp, torch.zeros_like(disp)))
            routed_aux.append(aux)
        del w_r
        self._done_with(r_pl, src)
        self._note_moe_rows(sum(disp.shape[1] for _, disp, _ in jobs))
        cold, streamed_cold = self._demand_cold_experts(layer, sorted(union),
                                                        by_name)
        for ids, disp, out_buf in jobs:
            eng.moe_experts_step(
                [(e, self._pinned[f"L{layer}/moe.expert{e}"])
                 for e in sorted(ids)
                 if f"L{layer}/moe.expert{e}" in self._pinned_names],
                disp, out_buf)
        self._compute_cold_experts(cold, streamed_cold, jobs)
        return [eng.moe_combine_step(x, out_buf, aux)
                for x, (_, _, out_buf), aux in zip(xs, jobs, routed_aux)], src

    # ------------------------------------------------------------ forward
    def _run_chunk(self, tokens, kv, pos: int):
        """One pass over all sub-layers for a token chunk.

        tokens: (B, T) int tensor on the device; kv: dict with stacked
        "k"/"v" tensors (L, B, KV, S, hd), written in place. Only the final
        position's logits are computed. Returns ((B, 1, V) logits, kv)."""
        self._check_alloc("chunk")
        by_name, streaming, started = self._begin_pass(
            self.schedule.pick_tier(tokens.shape[0] * tokens.shape[1]))
        try:
            x = eng.embed_step(self._embed_dev, tokens)
            k, v = kv["k"], kv["v"]
            x = self._layer_loop(
                x, by_name, streaming,
                lambda w, x, i: eng.attn_step(self.cfg, w, x, k, v, i, pos),
                mamba_fn=lambda w, x, j: eng.mamba_step(
                    self.cfg, w, x, kv["conv"][j], kv["ssm"][j]))
            logits = eng.head_step(self.cfg, self._final_dev,
                                   self._unembed_dev, x[:, -1:])
        finally:
            self._end_pass(started)
        return logits, kv

    def _decode_tier(self, new_tokens: int) -> int:
        return self.schedule.pick_decode_tier(
            new_tokens, queue_depth=self.sched_queue_depth,
            slack_s=self.sched_slack_s)

    def _run_decode(self, tokens, kv, pos_vec, active, n_active: int):
        """One fused multi-slot decode iteration, eagerly.

        tokens: (B, 1) last token per slot; pos_vec: (B,) per-slot cache
        positions; active: (B,) bool slot mask (on the device, or on the
        host, page-locked on a card, whence they are copied without a
        wait); n_active: batch-wide new token count (drives the tier
        pick). All slots run through one batched pass, so every streamed
        sub-layer crosses the link exactly once per iteration. ``kv``:
        the stacked dict, or a ``PagedKVCache`` whose pages this pass
        maps and restores. Returns ((B, 1, V) logits, kv)."""
        # before the page table is touched: an abort leaves nothing to undo
        self._check_alloc("decode")
        return self._decode_pass(tokens, kv, pos_vec, active, n_active,
                                 self._decode_tier(n_active))

    def decode_fused(self, tokens, kv, pos_vec, active, n_active: int, pick):
        """The serving loop's fused decode iteration: ``_run_decode``'s
        pass and ``pick(logits[:, -1])``, each slot's next token. Returns
        ((B, 1, V) logits, kv, (B,) tokens).

        A pass that can be recorded (``_graph_key``) is replayed: the
        first pass at a key runs eagerly on the capture stream and is then
        recorded (``core/cudagraph.py``: PyTorch's operations as CUDA
        graphs, K1–K3 launched between them), every later one copies its
        inputs into the recording's and replays it. The logits and tokens
        of a replay hold until the next decode pass. Every other pass runs
        ``_run_decode``'s eager pass."""
        self._check_alloc("decode")
        tier = self._decode_tier(n_active)
        key = self._graph_key(kv, tier, tokens.shape[0])
        if key is None:
            logits, kv = self._decode_pass(tokens, kv, pos_vec, active,
                                           n_active, tier)
            return logits, kv, pick(logits[:, -1])
        stamp = (tuple(t.data_ptr() for t in kv.values()), pick)
        g = self._graphs.get(key)
        if g is not None and g.stamp == stamp:
            for dst, src in zip(g.inputs, (tokens, pos_vec, active)):
                dst.copy_(src, non_blocking=True)
            logits, nxt = g.replay()
            self.stats.decode_graph_replays += 1
            cudagraph.apply(self.stats, g.counts)
            return logits, kv, nxt
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                       .copy_(t, non_blocking=True)
                       for t in (tokens, pos_vec, active))

        def run():
            logits, _ = self._decode_pass(inputs[0], kv, inputs[1],
                                          inputs[2], n_active, tier)
            return logits, pick(logits[:, -1])

        def captured():
            with cudagraph.counts_discarded(self):
                return run()
        at = cudagraph.mark(self.stats)
        logits, nxt = self.graph_capture.warm(self.device, run)
        counts = cudagraph.since(self.stats, at)
        self._graphs[key] = _Graph(
            stamp, inputs, self.graph_capture.capture(self.device, captured),
            counts)
        self.stats.decode_graph_captures += 1
        return logits, kv, nxt

    def _graph_key(self, kv, tier: int, batch: int):
        """``(tier, batch)``, the key a fused decode pass is graphed under,
        or None where it cannot be captured: a device the capture does not
        take, a paged cache (its pass maps pages on the host), an MoE model
        (the route is read on the host), or a tier plan that streams or
        copies at use any sub-layer (the prefetcher's host work). A graph
        is also tied to the cache storage it writes and to the token pick
        (``decode_fused``'s stamp), and ``rebind`` drops them all."""
        if not self.graph_capture.supports(self.device) \
                or isinstance(kv, PagedKVCache) or self.cfg.moe is not None:
            return None
        plan = self.schedule.tiers[tier].plan
        if any(p.sub.name not in self._pinned_names for p in plan.placements
               if p.sub.kind in PINNED_COMPUTE_KINDS):
            return None
        return tier, batch

    def _decode_pass(self, tokens, kv, pos_vec, active, n_active: int,
                     tier: int):
        """``_run_decode``'s pass at ``tier``, after its fault point."""
        tokens, pos_vec, active = (t.to(self.device, non_blocking=True)
                                   for t in (tokens, pos_vec, active))
        paged = isinstance(kv, PagedKVCache)
        page_demand = self._prepare_pages(kv, pos_vec, active, 1) \
            if paged else 0
        by_name, streaming, started = self._begin_pass(
            tier, page_demand_bytes=page_demand)
        page_stream = paged and self._demand_active
        streamed_before = self.stats.streamed_bytes
        expert_before = (self.stats.expert_demanded, self.stats.expert_hits,
                         self.stats.demanded_expert_bytes)
        self._layer_demanded = []
        try:
            x = eng.embed_step(self._embed_dev, tokens)
            if paged:
                def attn(w, x, i):
                    self._page_fault_layer(kv, i, page_stream)
                    x = eng.attn_decode_paged_step(
                        self.cfg, w, x, kv.k_pool, kv.v_pool,
                        kv.layer_table(i), pos_vec, active)
                    kv.end_layer(i)
                    return x
            else:
                def attn(w, x, i):
                    return eng.attn_decode_step(self.cfg, w, x, kv["k"],
                                                kv["v"], i, pos_vec, active)

            def mamba(w, x, j):
                return eng.mamba_step(self.cfg, w, x, kv["conv"][j],
                                      kv["ssm"][j], active=active)
            x = self._layer_loop(x, by_name, streaming, attn,
                                 mamba_fn=mamba)
            logits = eng.head_step(self.cfg, self._final_dev,
                                   self._unembed_dev, x)
        finally:
            self._end_pass(started)
            self._active_kvcache = None
        self.stats.decode_passes += 1
        self.stats.pass_streamed_bytes.append(
            self.stats.streamed_bytes - streamed_before)
        if self.expert_granular:
            d0, h0, b0 = expert_before
            demanded = self.stats.expert_demanded - d0
            self.stats.pass_expert_stats.append({
                "demanded": demanded,
                "hits": self.stats.expert_hits - h0,
                "demanded_bytes": self.stats.demanded_expert_bytes - b0,
                "resident_bytes": self.stats.resident_expert_bytes,
                "hit_rate": (self.stats.expert_hits - h0)
                / max(demanded, 1),
                "n_active": n_active,
                "layer_demanded": list(self._layer_demanded),
            })
        return logits, kv

    def _run_verify(self, tokens, kv, pos_vec, active, n_active: int):
        """One speculative verify pass: score ``W = k+1`` positions per
        active slot in a single streamed pass.

        tokens: (B, W) on the device — column 0 is each slot's last
        committed token at ``pos_vec``, columns 1..k the draft's
        proposals. Embedding, FFN / MoE and the head run over the whole
        (B, W) window, attention as a wavefront: W calls of the decode
        step, one per window column, each on a fresh (B, 1, d) column and
        the cache state sequential decode would see. Every op that reduces
        runs per column at the decode step's shape (the norms, the head)
        or has rows independent of M (K1–K3), so the pass equals W
        sequential decode steps bit for bit, while the weights cross the
        link once per layer and a cold expert is demanded once per layer
        and window. Rejected KV suffixes are undone by ``rollback_kv``.

        The tier pick sees ``n_active * W`` new tokens: a verify pass is a
        batch-wide token count of that size. Returns ((B, W, V) logits,
        kv)."""
        self._check_alloc("verify")
        B, W = tokens.shape
        paged = isinstance(kv, PagedKVCache)
        page_demand = self._prepare_pages(kv, pos_vec, active, W) \
            if paged else 0
        tier = self._decode_tier(n_active * W)
        by_name, streaming, started = self._begin_pass(
            tier, page_demand_bytes=page_demand)
        page_stream = paged and self._demand_active
        before = (self.stats.streamed_bytes,
                  self.stats.demanded_expert_bytes,
                  self.stats.demanded_page_bytes)
        # this tier's plan bytes, streamed whatever the demand traffic
        static_bytes = sum(
            p.sub.weight_bytes
            for p in self.schedule.tiers[tier].plan.static_stream_order()
            if p.sub.name not in self._pinned_names)
        self._layer_demanded = []
        try:
            x = eng.embed_step(self._embed_dev, tokens)

            def attn(w, x, i):
                if not paged:
                    return torch.cat([eng.attn_decode_step(
                        self.cfg, w, eng.column(x, j), kv["k"], kv["v"], i,
                        pos_vec + j, active) for j in range(W)], dim=1)
                # prepare_verify mapped all W positions up front: the table
                # holds across the window, only the pools change
                self._page_fault_layer(kv, i, page_stream)
                table = kv.layer_table(i)
                x = torch.cat([eng.attn_decode_paged_step(
                    self.cfg, w, eng.column(x, j), kv.k_pool, kv.v_pool,
                    table, pos_vec + j, active) for j in range(W)], dim=1)
                kv.end_layer(i)
                return x

            x = self._layer_loop(x, by_name, streaming, attn, cols=True)
            # unlike a prefill the head scores ALL W positions: the
            # acceptance loop needs the target's argmax at every one
            logits = torch.cat([eng.head_step(self.cfg, self._final_dev,
                                              self._unembed_dev,
                                              eng.column(x, j))
                                for j in range(W)], dim=1)
        finally:
            self._end_pass(started)
            self._active_kvcache = None
        self.stats.spec_verify_passes += 1
        self.stats.verify_pass_stats.append({
            "width": W,
            "streamed_bytes": self.stats.streamed_bytes - before[0],
            "static_plan_bytes": static_bytes,
            "demanded_expert_bytes":
                self.stats.demanded_expert_bytes - before[1],
            "demanded_page_bytes":
                self.stats.demanded_page_bytes - before[2],
        })
        return logits, kv

    def rollback_kv(self, kv, keep_pos, rollback_mask):
        """Undo the KV writes a verify pass made for rejected positions.
        ``keep_pos[b]`` is the first cache index to clear for slot ``b``
        (old pos + accepted count); ``rollback_mask[b]`` selects the slots
        that rejected a suffix (host arrays). A stacked cache zeroes the
        tail in place (``engine.rollback_step``: byte-equal to never having
        written it); a paged cache truncates through the page table,
        releasing whole rejected blocks and zeroing the partial one."""
        keep_h = np.asarray(keep_pos)
        mask_h = np.asarray(rollback_mask)
        if isinstance(kv, PagedKVCache):
            for s in range(len(mask_h)):
                if mask_h[s]:
                    kv.truncate(int(s), int(keep_h[s]))
            return kv
        eng.rollback_step(kv["k"], kv["v"],
                          torch.as_tensor(keep_h).to(self.device),
                          torch.as_tensor(mask_h).to(self.device))
        return kv

    def init_kv(self, batch):
        if self.kv_layout == "paged":
            n_pages = None if self.kv_pool_pages is None \
                else self.kv_pool_pages + 1      # + the null write sink
            cache = PagedKVCache(self.cfg, batch, self.max_seq,
                                 page_size=self.kv_page_size,
                                 n_pages=n_pages, device=self.device)
            cache.fault_plan = self.faults     # the alloc.host point
            return cache
        if not self.cfg.layer_pattern:
            return init_cache(self.cfg, batch, self.max_seq,
                              device=self.device)
        return self._init_hybrid_cache(batch)

    def _init_hybrid_cache(self, batch):
        """A patterned hybrid's cache, zero-filled: the attention layers'
        stacked KV, (n_attn, B, KV, S, hd) in bf16, and each Mamba-2
        layer's conv history (n_mamba, B, K-1, C) in the model's dtype and
        SSM state (n_mamba, B, H, P, N) in f32."""
        cfg, dev = self.cfg, self.device
        n_attn, n_mamba = (cfg.layer_pattern.count(k) for k in "*M")
        kv_shape = (n_attn, batch, cfg.n_kv_heads, self.max_seq,
                    cfg.resolved_head_dim)
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache = {
            "k": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
            "conv": torch.zeros((n_mamba, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=self._embed_dev.dtype, device=dev),
            "ssm": torch.zeros((n_mamba, batch, cfg.n_ssm_heads,
                                cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=dev)}
        self.stats.ssm_state_bytes = sum(
            cache[k].numel() * cache[k].element_size()
            for k in ("conv", "ssm"))
        return cache

    @property
    def has_state(self) -> bool:
        """True when the cache holds recurrent state, which an admission
        must zero (stacked KV needs no reset: a position past a slot's
        length is masked)."""
        return "M" in self.cfg.layer_pattern

    def reset_state(self, kv, slot: int):
        """Zero slot ``slot``'s conv and SSM state in every Mamba-2 layer,
        so a request admitted there starts from nothing its slot held."""
        kv["conv"][:, slot].zero_()
        kv["ssm"][:, slot].zero_()
        self.stats.state_resets += 1

    def prefill(self, tokens, kv=None, prefill_mode: str | None = None,
                slot: int | None = None):
        """Chunked prefill at the planner-picked tier size.

        ``prefill_mode`` overrides the executor default for this call:
        ``"layer_major"`` streams each sub-layer once per prompt and runs
        every chunk against the resident weights (weight-stationary);
        ``"chunk_major"`` runs one full plan pass per chunk. ``kv`` lets a
        caller (the serving batcher) prefill into an existing cache;
        ``slot`` targets one row of that shared cache (B must be 1). A
        paged ``kv`` also runs the prefix-cache lookup for a single
        sequence: matched full blocks are mapped read-only and only the
        suffix is computed, then its full blocks are published.
        Returns ((B, 1, V) last logits, kv, T)."""
        mode = prefill_mode if prefill_mode is not None else \
            self.prefill_mode
        if mode not in ("layer_major", "chunk_major"):
            raise ValueError(f"unknown prefill_mode {mode!r}")
        # before anything of the pass: the prefix lookup, the page table,
        # the copy of the tokens
        self._check_alloc("prefill")
        tokens = tokens.to(self.device)
        B, T = tokens.shape
        if kv is None:
            kv = self.init_kv(B)
        paged = isinstance(kv, PagedKVCache)
        if (paged or slot is not None) and mode != "layer_major":
            raise ValueError("paged / slot-targeted prefill runs "
                             "layer-major only")
        if slot is not None and B != 1:
            raise ValueError("slot-targeted prefill admits ONE sequence")
        rows, pos0, page_demand = None, 0, 0
        if paged:
            rows = [slot] if slot is not None else list(range(B))
            tok_np = trace.to_host(tokens, "pages")
            if B == 1:
                pos0 = kv.prefix_attach(rows[0], tok_np[0])
            faults = kv.prepare_prefill([(r, T, pos0) for r in rows])
            page_demand = kv.layer_fault_bytes(faults)
            self._active_kvcache = kv
        if mode == "layer_major":
            tier = self.schedule.pick_prefill_tier(
                B * (T - pos0), min_tier=B,
                queue_depth=self.sched_queue_depth)
        else:
            tier = self.schedule.pick_tier(B * T)
        if tier // B < 1:
            raise ValueError(
                f"picked tier {tier} cannot chunk a batch of {B} sequences "
                "(tier // batch < 1 token per sequence per chunk); widen "
                "the tier table or shrink the batch")
        before = self._prefill_snapshot()
        if mode == "layer_major":
            # always the full tier chunk — a short prompt pads up instead
            # of shrinking the chunk
            chunk = tier // B
            try:
                logits, ring_bytes = self._prefill_layer_major(
                    tokens[:, pos0:], kv, chunk, tier, slot=slot, rows=rows,
                    pos0=pos0, page_demand=page_demand)
            finally:
                self._active_kvcache = None
            if paged and B == 1:
                kv.prefix_register(rows[0], tok_np[0])
            chunks = -(-(T - pos0) // chunk)
        else:
            chunk = min(T, tier // B)
            logits = None
            pos = 0
            chunks = 0
            # chunk-major holds ONE chunk's residual at a time
            ring_bytes = B * chunk * self.cfg.d_model * 2
            while pos < T:
                end = min(T, pos + chunk)
                logits, kv = self._run_chunk(tokens[:, pos:end], kv, pos)
                self.stats.prefill_passes += 1
                chunks += 1
                pos = end
        self._record_prefill(mode, chunks, before, ring_bytes,
                             tokens=T - pos0, prefix_tokens=pos0)
        return logits[:, -1:], kv, T

    def _prefill_layer_major(self, tokens, kv, chunk: int, tier: int,
                             slot: int | None = None, rows=None,
                             pos0: int = 0, page_demand: int = 0):
        """Weight-stationary prefill: ONE prefetch session per prompt; for
        each sub-layer in stream order, all chunks run against the resident
        weights before the stream advances — so each streamed sub-layer
        crosses the link once per prompt instead of once per chunk.
        Causally valid: chunk c's attention at layer L reads only the
        layer-L KV prefix, which chunks 0..c-1 wrote earlier in this same
        layer step. The tail chunk is padded to ``chunk`` and masked out of
        the KV cache — unless the padded write window would run past
        ``max_seq`` (the clamped write would shift over valid positions) or
        an MoE chunk would leave the dropless capacity regime (padding
        grows the capacity, which could keep assignments the unpadded
        chunk drops); then the tail runs at its natural length.
        ``tokens`` are the positions from ``pos0`` on (a paged prefix hit
        covers the ones before); a paged cache's pages are restored and
        its table read per layer (``rows``: the slots of the batch)."""
        cfg = self.cfg
        paged = isinstance(kv, PagedKVCache)
        B, T = tokens.shape
        C = -(-T // chunk)
        tail = T - (C - 1) * chunk
        pad_ok = pos0 + C * chunk <= self.max_seq and (
            cfg.moe is None
            or mlp_mod.capacity_is_dropless(B * chunk, cfg.moe))
        pad = C * chunk - T if pad_ok else 0
        if pad:
            tokens = F.pad(tokens, (0, pad))
        by_name, streaming, started = self._begin_pass(
            tier, page_demand_bytes=page_demand)
        page_stream = paged and self._demand_active
        try:
            xs = [eng.embed_step(self._embed_dev,
                                 tokens[:, c * chunk:(c + 1) * chunk])
                  for c in range(C)]
            valid = [chunk if c < C - 1 else tail for c in range(C)]
            # the rows of the batch in a hybrid's state: the slot's, or all
            row = slice(slot, slot + 1) if slot is not None else slice(None)

            def attn(w, xs, i):
                if paged:
                    self._page_fault_layer(kv, i, page_stream)
                    table = kv.layer_table(i, rows=rows)
                    xs = [eng.attn_prefill_paged_step(
                        cfg, w, xs[c], kv.k_pool, kv.v_pool, table,
                        pos0 + c * chunk, valid[c]) for c in range(C)]
                    kv.end_layer(i)
                    return xs
                if slot is not None:
                    return [eng.attn_prefill_slot_step(
                        cfg, w, xs[c], kv["k"], kv["v"], i, slot,
                        c * chunk, valid[c]) for c in range(C)]
                return [eng.attn_prefill_step(
                    cfg, w, xs[c], kv["k"], kv["v"], i, c * chunk, valid[c])
                    for c in range(C)]

            def mamba(w, xs, j):
                # each chunk from the state the one before it left
                return [eng.mamba_step(cfg, w, xs[c], kv["conv"][j, row],
                                       kv["ssm"][j, row], valid[c])
                        for c in range(C)]
            prev_engine = None
            for i in range(cfg.n_layers):
                has_attn, has_ffn, has_mamba = self._kinds(i)
                if has_mamba:
                    xs, prev_engine = self._mixer_sub(
                        i, "mamba", xs, mamba, by_name, streaming,
                        prev_engine, calls=C)
                if has_attn:
                    xs, prev_engine = self._mixer_sub(
                        i, "attn", xs, attn, by_name, streaming,
                        prev_engine, calls=C)
                if has_ffn:
                    xs, prev_engine = self._ffn_sub(i, xs, valid, by_name,
                                                    streaming, prev_engine)
            # final logits from the last VALID position only
            logits = eng.head_step(cfg, self._final_dev, self._unembed_dev,
                                   xs[-1][:, tail - 1:tail])
        finally:
            self._end_pass(started)
        self.stats.prefill_passes += 1
        # the activation ring: every chunk's residual held at once
        return logits, B * tokens.shape[1] * cfg.d_model * 2

    def _prefill_snapshot(self):
        s = self.stats
        return (s.streamed_bytes, s.prefill_passes, s.demanded_expert_bytes,
                s.demanded_page_bytes)

    def _record_prefill(self, mode, chunks, before, ring_bytes, tokens=0,
                        prefix_tokens=0):
        s = self.stats
        s.prefill_stats.append({
            "mode": mode,
            "chunks": chunks,
            # prefilled suffix against prefix-cache coverage: a prefix hit
            # shows as prefix_tokens > 0 and fewer tokens
            "tokens": tokens,
            "prefix_tokens": prefix_tokens,
            "act_ring_bytes": ring_bytes,
            "passes": s.prefill_passes - before[1],
            "streamed_bytes": s.streamed_bytes - before[0],
            "demanded_expert_bytes": s.demanded_expert_bytes - before[2],
            "demanded_page_bytes": s.demanded_page_bytes - before[3],
        })

    def decode(self, last_tokens, kv, pos: int, steps=8):
        """Greedy decode loop; returns (B, steps) numpy tokens and kv. A
        paged cache decodes through the fused multi-slot pass with every
        row active."""
        out = []
        tok = last_tokens.to(self.device)
        if isinstance(kv, PagedKVCache):
            B = tok.shape[0]
            active = torch.ones((B,), dtype=torch.bool, device=self.device)
            for s in range(steps):
                pos_vec = torch.full((B,), pos + s, dtype=torch.int32,
                                     device=self.device)
                logits, kv = self._run_decode(tok, kv, pos_vec, active, B)
                tok = greedy_token(logits[:, -1:])
                out.append(tok[:, 0].cpu().numpy())
            return np.stack(out, axis=1), kv
        for s in range(steps):
            logits, kv = self._run_chunk(tok, kv, pos + s)
            tok = greedy_token(logits[:, -1:])
            out.append(tok[:, 0].cpu().numpy())
        return np.stack(out, axis=1), kv
