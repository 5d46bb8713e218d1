"""Pipelined-sharding planner (paper Algorithm 1, planning phase).

For each token tier: pin the highest-priority sub-layers into the pinnable
part of the VRAM/HBM budget (attention > KV cache > FFN > outputs), then
generate the three fundamental plans for the remainder and keep the
cheapest per the profile-driven estimator:

  GPU-only  — all unpinned sub-layers execute on the accelerator, weights
              streamed just-in-time into a scratch double-buffer.
  Static    — unpinned sub-layers stay in sysRAM and execute on the CPU;
              only activations cross the link.
  Dynamic   — cost-balanced hybrid: sub-layers go to the CPU while their CPU
              time fits under the accumulated streaming time of the
              GPU-streamed ones (CPU compute hides under the link).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.costmodel import (Placement, Plan, TimingEstimator,
                                        kv_block_bytes)
from repro_torch.core.kvpaged import PAGE_SIZE as KV_PAGE_SIZE
from repro_torch.core.sublayer import (CACHE_KINDS, STREAMABLE_KINDS,
                                      SubLayer)
from repro_torch.core.system import InferenceSetting

TIERS = (1, 4, 16, 32, 64, 512, 1024, 2048, 4096, 8192, 16384)

# Sub-layer kinds whose weights the executor actually pins on device (the
# canonical pin set is the min-tier plan's vram placements of these kinds —
# kv residency is tracked by the plans but the cache arrays live with the
# executor/batcher, not the pin store). Schedule.diff and
# PipelinedExecutor.rebind MUST agree on this set, byte for byte
# (DESIGN.md §8). Expert-granular MoE graphs (DESIGN.md §9) pin the router
# shard and individual expert shards, so a live re-plan moves single
# experts instead of whole FFNs.
PINNED_COMPUTE_KINDS = ("attn", "ffn", "moe", "mamba", "moe_router",
                        "moe_expert")


@dataclass
class TierEntry:
    plan: Plan
    est_time: float
    scratch_bytes: int = 0   # VRAM scratch granted at this tier
    act_bytes: int = 0       # activation reservation inside that scratch
    # one weight-stationary repeat chunk (DESIGN.md §10): the plan's pass
    # time with streamed weight bytes excluded — what every chunk after
    # the first costs under layer-major prefill, where weights cross the
    # link once per prompt instead of once per chunk
    prefill_chunk_s: float = 0.0


@dataclass
class ScheduleDiff:
    """Delta between two schedules over the same sub-layer graph — what a
    live re-plan must move (DESIGN.md §8).

    ``to_pin``/``to_evict`` list sub-layer names entering/leaving the
    canonical pinned set (min-tier plan, ``PINNED_COMPUTE_KINDS``), in the
    model's execution order; ``pin_bytes``/``evict_bytes`` are their weight
    bytes — exactly the host->device / free traffic an incremental
    ``PipelinedExecutor.rebind`` performs.  ``tier_plan_changes`` maps each
    tier whose winning fundamental plan changed to ``(old, new)`` plan
    names, and ``stream_bytes_changes`` to ``(old, new)`` per-pass streamed
    weight bytes at that tier.
    """
    to_pin: List[str]
    to_evict: List[str]
    pin_bytes: int
    evict_bytes: int
    tier_plan_changes: Dict[int, Tuple[str, str]]
    stream_bytes_changes: Dict[int, Tuple[int, int]]

    @property
    def moved_bytes(self) -> int:
        return self.pin_bytes + self.evict_bytes

    @property
    def empty(self) -> bool:
        return not (self.to_pin or self.to_evict or self.tier_plan_changes
                    or self.stream_bytes_changes)

    def summary(self) -> str:
        return (f"pin {len(self.to_pin)} subs ({self.pin_bytes / 1e6:.1f}MB) "
                f"evict {len(self.to_evict)} subs "
                f"({self.evict_bytes / 1e6:.1f}MB), "
                f"{len(self.tier_plan_changes)} tier plan changes")


@dataclass
class Schedule:
    """Planner output: per-tier best plans + metadata."""
    tiers: Dict[int, TierEntry]
    pinned_bytes: int
    scratch_bytes: int
    budget_bytes: int
    match_stats: dict = field(default_factory=dict)
    # paged-KV pool sizing (DESIGN.md §12): the VRAM bytes the paged cache's
    # page pool may occupy under this budget (the kv residency the pin pass
    # reserved, floored at a sliding-window working set), and the block
    # granularity it was sized for. 0 when the graph carries no kv subs.
    kv_pool_bytes: int = 0
    kv_page_size: int = KV_PAGE_SIZE

    def pick_tier(self, batch_tokens: int) -> int:
        """Paper: argmin over ceil(tokens/tier) * time[tier].

        Iterates tiers in ascending order with a strict improvement test, so
        cost ties break deterministically toward the *smaller* tier (less
        scratch, less padding) regardless of dict insertion order.
        """
        best, best_cost = None, float("inf")
        for t in sorted(self.tiers):
            cost = math.ceil(batch_tokens / t) * self.tiers[t].est_time
            if cost < best_cost:
                best, best_cost = t, cost
        return best

    def pick_decode_tier(self, active_slots: int, queue_depth: int = 0,
                         slack_s: Optional[float] = None) -> int:
        """Tier for one fused decode iteration: the batch-wide new-token
        count is one token per active slot (paper: PickTier runs over the
        whole batch, never per request), so the iteration's plan is the one
        picked for ``active_slots`` tokens. See DESIGN.md §7.

        ``queue_depth`` makes the pick *queue-aware* (DESIGN.md §13): the
        caller passes how many queued admissions can actually join the
        batch (capped at its free slots), and the tier is picked for that
        imminent batch instead of the current one — an admission burst
        steps up to the larger tier one iteration early, and an idle queue
        leaves the pick exactly as before. ``slack_s`` is the tightest
        deadline slack across live requests: when the anticipated tier's
        iteration time would overrun it, the anticipation is vetoed and
        the fastest plan for the *current* tokens wins — latency-critical
        iterations never pay burst-sized padding."""
        tokens = max(1, active_slots)
        anticipated = tokens + max(0, queue_depth)
        t = self.pick_tier(anticipated)
        if slack_s is not None and anticipated > tokens \
                and self.tiers[t].est_time > slack_s:
            return self.pick_tier(tokens)
        return t

    def prefill_time(self, batch_tokens: int, tier: int) -> float:
        """Layer-major weight-stationary prefill cost at ``tier``
        (DESIGN.md §10): streamed weights cross the link ONCE per prompt
        while compute repeats per chunk, so TTFT is bounded by whichever
        dominates — the single full pass (1x stream + one chunk's compute,
        link-bound prompts) or chunks x the weight-stationary per-chunk
        time (compute-bound prompts, the stream fully hidden)."""
        e = self.tiers[tier]
        chunks = math.ceil(batch_tokens / tier)
        return max(e.est_time, chunks * e.prefill_chunk_s)

    def pick_prefill_tier(self, batch_tokens: int, min_tier: int = 1,
                          queue_depth: int = 0) -> int:
        """Chunk-size pick for layer-major prefill. Re-streaming no longer
        penalises small chunks (the transfer term is per-prompt, not
        per-chunk), so the optimum usually sits at a smaller tier — less
        scratch, less padding — than ``pick_tier``'s, which pays the plan's
        streamed bytes every chunk. ``min_tier`` floors the pick (the
        executor needs ``tier >= batch`` for at least one token per
        sequence per chunk); ties break toward the smaller tier.

        ``queue_depth`` raises that floor to the *imminent* batch
        (DESIGN.md §13): queued admissions will have joined the decode
        batch by the time this chunk executable repeats, and the executor
        needs ``tier >= batch``, so picking for the current batch alone
        would choose a chunking the very next admission outgrows. Idle
        queues leave the floor — and therefore the pick — untouched."""
        best, best_cost = None, float("inf")
        floor = min_tier + max(0, queue_depth)
        for t in sorted(self.tiers):
            if t < floor:
                continue
            cost = self.prefill_time(batch_tokens, t)
            if cost < best_cost:
                best, best_cost = t, cost
        return best if best is not None else max(self.tiers)

    def time_for_tokens(self, batch_tokens: int) -> float:
        t = self.pick_tier(batch_tokens)
        return math.ceil(batch_tokens / t) * self.tiers[t].est_time

    def plan_for_tokens(self, batch_tokens: int) -> Plan:
        return self.tiers[self.pick_tier(batch_tokens)].plan

    # ------------------------------------------------------------ live diff
    def pinned_placements(self) -> List[Placement]:
        """Canonical executor pin set: the min-tier plan's vram placements
        of ``PINNED_COMPUTE_KINDS``, in execution order. The paper pins
        identically across tiers, so the smallest tier's plan is the single
        source of truth for what is resident (DESIGN.md §8)."""
        plan = self.tiers[min(self.tiers)].plan
        return [p for p in plan.placements
                if p.residency == "vram" and p.sub.kind in PINNED_COMPUTE_KINDS]

    def pinned_weight_map(self) -> Dict[str, int]:
        """name -> weight bytes for the canonical pinned set."""
        return {p.sub.name: p.sub.weight_bytes for p in self.pinned_placements()}

    @property
    def expert_granular(self) -> bool:
        """True when the underlying graph splits MoE FFNs into router +
        per-expert shards (DESIGN.md §9)."""
        plan = self.tiers[min(self.tiers)].plan
        return any(p.sub.kind == "moe_router" for p in plan.placements)

    def diff(self, new: "Schedule") -> ScheduleDiff:
        """Pin/evict/stream deltas required to go from ``self`` to ``new``.

        Both schedules must be built over the same sub-layer graph (same
        names); the diff is what ``PipelinedExecutor.rebind`` applies
        incrementally — moving only these bytes, never re-pinning the
        unchanged intersection (DESIGN.md §8).
        """
        old_pins = self.pinned_weight_map()
        new_pins = {p.sub.name: p.sub.weight_bytes
                    for p in new.pinned_placements()}
        to_pin = [n for n in new_pins if n not in old_pins]
        to_evict = [n for n in old_pins if n not in new_pins]
        plan_changes: Dict[int, Tuple[str, str]] = {}
        stream_changes: Dict[int, Tuple[int, int]] = {}
        for t in sorted(set(self.tiers) & set(new.tiers)):
            po, pn = self.tiers[t].plan, new.tiers[t].plan
            if po.name != pn.name:
                plan_changes[t] = (po.name, pn.name)
            so, sn = po.streamed_weight_bytes(), pn.streamed_weight_bytes()
            if so != sn:
                stream_changes[t] = (so, sn)
        return ScheduleDiff(
            to_pin=to_pin, to_evict=to_evict,
            pin_bytes=sum(new_pins[n] for n in to_pin),
            evict_bytes=sum(old_pins[n] for n in to_evict),
            tier_plan_changes=plan_changes,
            stream_bytes_changes=stream_changes)


# Live activation buffers during one sub-layer step: residual x, normed
# input, sub-layer output, and one temporary (e.g. the FFN hidden reuses the
# temporary slot tile-by-tile under the streamed-matmul pipeline).
ACT_BUFFERS = 4


def activation_bytes(subs: List[SubLayer], setting: InferenceSetting,
                     tier: int) -> int:
    """Activation working set inside the scratch at this tier:
    ``ACT_BUFFERS * tokens * d * act_bytes`` with tokens = max(tier, batch)
    (a tier-sized prefill chunk, or one token per sequence at decode)."""
    d = max((s.meta.get("d", 0) for s in subs), default=0)
    tokens = max(tier, setting.batch)
    return ACT_BUFFERS * tokens * d * setting.act_dtype_bytes


def decide_scratch_budget(budget: int, subs: List[SubLayer],
                          setting: InferenceSetting, tier: int) -> int:
    """VRAM scratch sizing for the copy-compute pipeline:

        scratch = 2 * max_w + ACT_BUFFERS * tokens * d * act_bytes

    where ``2 * max_w`` is the double-buffer holding the largest
    *streamable* shard's weights (slot i computes while slot i+1 copies),
    ``tokens = max(tier, batch)`` is the activation row count actually in
    flight (a tier-sized prefill chunk, or one token per sequence at
    decode — whichever is larger), ``d`` the widest model dim, and
    ``act_bytes`` the activation dtype width from the inference setting.
    Only shards the executor can actually stream (``STREAMABLE_KINDS``)
    size the buffer — embed/output heads never enter the scratch, and an
    expert-granular MoE graph's unit is a single expert, not the whole
    FFN, so tight budgets that lost the double-buffer against a monolithic
    ``moe`` sub-layer regain the overlap after the split (DESIGN.md §9).
    The full double-buffer is granted whenever it fits the budget (pinning
    gets the remainder — the overlap mechanism outranks extra pins); only
    when it cannot fit does the single-buffer fallback keep at least half
    the budget pinnable.
    """
    max_w = max((s.weight_bytes for s in subs
                 if s.kind in STREAMABLE_KINDS), default=0)
    # expert-granular graphs reserve one extra demand slot: demanded cold
    # experts stage through their own pool so they never queue behind the
    # static look-ahead (DESIGN.md §9) — that pool's shard must fit the
    # scratch too, or the prefetcher would over-commit the reservation
    demand_w = max((s.weight_bytes for s in subs
                    if s.kind == "moe_expert"), default=0)
    act = activation_bytes(subs, setting, tier)
    want = 2 * max_w + demand_w + act
    if want <= budget:
        # grant the full double-buffer; pinning gets the remainder (at real
        # model scales `want` is far below half the budget anyway)
        return want
    # double-buffer cannot fit: degrade to a single staging buffer and keep
    # at least half the budget pinnable
    return min(budget // 2, max_w + act)


def pin_by_priority(pinned_budget: int, subs: List[SubLayer],
                    setting: InferenceSetting):
    """Fit as many sub-layers as possible, priority order (stable by layer).

    Within a priority class, shards with a higher routing frequency
    (``meta["hot"]``, expert shards) pin first — the hot-set selection of
    DESIGN.md §9. Non-expert sub-layers carry no ``hot`` key, so their
    relative order is untouched (the sort is stable).

    A sub-layer carrying ``meta["pin_veto"]`` is never pinned regardless
    of budget — the emergency-rebudget ladder (DESIGN.md §15) vetoes the
    colder half of the expert hot set to free VRAM without changing any
    computed value: a vetoed expert is demand-streamed instead, which is
    bit-identical by the §9 fold path."""
    order = sorted(subs,
                   key=lambda s: (s.priority, -s.meta.get("hot", 0.0),
                                  s.layer))
    pinned, remaining = set(), []
    used = 0
    for s in order:
        if s.meta.get("pin_veto"):
            remaining.append(s)
            continue
        b = s.bytes_resident(setting)
        if used + b <= pinned_budget:
            pinned.add(s.name)
            used += b
        else:
            remaining.append(s)
    return pinned, used


def _mk(sub, pinned):
    if sub.name in pinned:
        return Placement(sub, "vram", "gpu", streamed=False)
    return None


def plan_gpu_only(subs, pinned) -> Plan:
    pls = []
    for s in subs:
        p = _mk(s, pinned)
        if p is None:
            res = "sysram"
            p = Placement(s, res, "gpu", streamed=s.kind not in CACHE_KINDS)
        pls.append(p)
    return Plan("gpu-only", pls)


def plan_static(subs, pinned) -> Plan:
    pls = []
    for s in subs:
        p = _mk(s, pinned)
        if p is None:
            p = Placement(s, "sysram", "cpu", streamed=False)
        pls.append(p)
    return Plan("static", pls)


def plan_dynamic(subs, pinned, est: TimingEstimator, tier: int,
                 setting: InferenceSetting) -> Plan:
    """Greedy cost balance: CPU picks up sub-layers while its accumulated
    time hides under the accumulated GPU weight-streaming time."""
    link_bw = est.sys.link_gbps * 1e9
    pls = []
    cum_cpu = 0.0
    cum_stream = 0.0
    for s in subs:
        p = _mk(s, pinned)
        if p is not None:
            pls.append(p)
            continue
        if s.kind in CACHE_KINDS:
            pls.append(Placement(s, "sysram", "cpu", streamed=False))
            continue
        t_cpu = est.sublayer_compute(s, "cpu", tier, setting, pcie_active=True)
        t_stream = s.weight_bytes / link_bw
        if cum_cpu + t_cpu <= cum_stream + t_stream:
            cum_cpu += t_cpu
            pls.append(Placement(s, "sysram", "cpu", streamed=False))
        else:
            cum_stream += t_stream
            pls.append(Placement(s, "sysram", "gpu", streamed=True))
    return Plan("dynamic", pls)


def plan_tier(budget: int, subs: List[SubLayer], est: TimingEstimator,
              setting: InferenceSetting, tier: int) -> TierEntry:
    scratch = decide_scratch_budget(budget, subs, setting, tier)
    pinned_budget = budget - scratch
    pinned, _used = pin_by_priority(pinned_budget, subs, setting)
    plans = [
        plan_gpu_only(subs, pinned),
        plan_static(subs, pinned),
        plan_dynamic(subs, pinned, est, tier, setting),
    ]
    for p in plans:
        p.est_time = est.plan_time(p, tier, setting)
    best = min(plans, key=lambda p: p.est_time)
    # the weight-stationary repeat cost (DESIGN.md §10): same plan, same
    # chunk, streamed weight bytes excluded; restore detail afterwards so
    # the full-pass breakdown stays the headline one
    detail = best.detail
    chunk_s = est.plan_time(best, tier, setting,
                            include_streamed_weights=False)
    best.detail = detail
    return TierEntry(best, best.est_time, scratch_bytes=scratch,
                     act_bytes=activation_bytes(subs, setting, tier),
                     prefill_chunk_s=chunk_s)


def decide_kv_pool_bytes(subs: List[SubLayer], setting: InferenceSetting,
                         pinned, page_size: int = KV_PAGE_SIZE) -> int:
    """Paged-KV page-pool sizing (DESIGN.md §12).

    The pool gets the KV residency the priority pin pass reserved under
    this budget, floored at a sliding-window working set — two layers of
    the active batch's blocks plus one block of demand margin — so a pass
    can always pin its current layer's blocks while the previous layer's
    drain and the next layer's restore. With an ample budget the reserved
    bytes cover the full stacked demand and the pool never evicts (paged
    becomes a pure layout change); under pressure the floor is what lets
    the paged layout keep serving where the stacked allocation would
    simply not fit.
    """
    kv_subs = [s for s in subs if s.kind == "kv"]
    if not kv_subs:
        return 0
    blocks_per_seq = -(-setting.context // page_size)
    block_bytes = max(kv_block_bytes(s, page_size) for s in kv_subs)
    floor = (2 * setting.batch * blocks_per_seq + 1) * block_bytes
    reserved = sum(s.bytes_resident(setting) for s in kv_subs
                   if s.name in pinned)
    return max(reserved, floor)


def build_schedule(budget_bytes: int, subs: List[SubLayer],
                   est: TimingEstimator, setting: InferenceSetting,
                   tiers=TIERS, kv_page_size: int = KV_PAGE_SIZE) -> Schedule:
    entries = {}
    for t in tiers:
        e = plan_tier(budget_bytes, subs, est, setting, t)
        entries[t] = e
    # headline numbers reported at the smallest tier; per-tier scratch lives
    # on each TierEntry
    scratch = entries[tiers[0]].scratch_bytes
    pinned, used = pin_by_priority(budget_bytes - scratch, subs, setting)
    return Schedule(tiers=entries, pinned_bytes=used, scratch_bytes=scratch,
                    budget_bytes=budget_bytes,
                    match_stats=dict(est.match_stats),
                    kv_pool_bytes=decide_kv_pool_bytes(subs, setting, pinned,
                                                       kv_page_size),
                    kv_page_size=kv_page_size)


# ---------------------------------------------------------------- metrics
def estimate_ttft(sched: Schedule, isl: int, mode: str = "layer_major",
                  prefix_hit_frac: float = 0.0) -> float:
    """Context phase. The default models the layer-major weight-stationary
    prefill (DESIGN.md §10): streamed plan bytes cross the link once per
    prompt, compute repeats per chunk. ``mode="chunk_major"`` keeps the
    chunk-major model — every chunk re-pays the plan's full transfer, so
    the TTFT transfer term grows linearly with prompt length.
    ``prefix_hit_frac`` is the expected prefix-cache coverage of the prompt
    (DESIGN.md §12): matched blocks map pages instead of prefilling, so
    only the remaining fraction is computed (floored at one token — a hit
    never covers the last position)."""
    if not 0.0 <= prefix_hit_frac <= 1.0:
        raise ValueError(f"prefix_hit_frac {prefix_hit_frac} not in [0, 1]")
    isl = max(1, int(round(isl * (1.0 - prefix_hit_frac))))
    if mode == "chunk_major":
        return sched.time_for_tokens(isl)
    return sched.prefill_time(isl, sched.pick_prefill_tier(isl))


def estimate_tps(sched: Schedule, batch: int = 1) -> float:
    """Decode phase: batch-wide new tokens per iteration = batch."""
    t = sched.time_for_tokens(batch)
    return batch / max(t, 1e-12)


# ---------------------------------------------------------- speculation
def plan_draft_carve(budget_bytes: int, draft_subs: List[SubLayer],
                     target_subs: List[SubLayer], est: TimingEstimator,
                     setting: InferenceSetting,
                     tiers=TIERS) -> Tuple[Optional[Schedule], int]:
    """Carve the VRAM budget between the target's pins and a wholly
    resident draft model (DESIGN.md §14).

    The draft is only worth running if it never streams: its carve is the
    bytes that pin EVERY compute sub-layer plus its KV residency plus its
    own scratch (activations + the double-buffer sizing its schedule
    reserves — unused for streaming, but the planner's accounting is kept
    uniform so ``build_schedule`` over the carve yields an all-pinned
    plan). Feasibility requires (a) the remaining budget still fits the
    target's floor — the largest streamable shard's double-buffer plus
    min-tier activations, i.e. the target can still run a streamed plan
    at all — and (b) the draft schedule's pin pass actually pinned every
    compute sub-layer. Returns ``(draft_schedule, carve_bytes)`` or
    ``(None, 0)`` when infeasible — in which case the caller plans the
    target at the FULL budget, byte-for-byte today's schedule.
    """
    compute = [s for s in draft_subs if s.kind in PINNED_COMPUTE_KINDS]
    kv = [s for s in draft_subs if s.kind == "kv"]
    pin_bytes = sum(s.weight_bytes for s in compute) \
        + sum(s.bytes_resident(setting) for s in kv)
    carve = int(pin_bytes + decide_scratch_budget(budget_bytes, draft_subs,
                                                  setting, tiers[0]))
    remaining = budget_bytes - carve
    target_floor = 2 * max((s.weight_bytes for s in target_subs
                            if s.kind in STREAMABLE_KINDS), default=0) \
        + activation_bytes(target_subs, setting, tiers[0])
    if remaining < target_floor:
        return None, 0
    draft_sched = build_schedule(carve, draft_subs, est, setting, tiers)
    pinned_names = {p.sub.name for p in draft_sched.pinned_placements()}
    if any(s.name not in pinned_names for s in compute):
        return None, 0
    return draft_sched, carve


def estimate_spec_tps(sched: Schedule, draft_step_s: float,
                      accept_rate: float, k: int, batch: int = 1) -> float:
    """Committed tokens/s of speculative decode at window ``k`` under the
    target's ``sched`` (DESIGN.md §14): the truncated-geometric expected
    tokens per verify pass over the iteration time — ``k`` draft steps
    plus one verify pass of ``batch * (k+1)`` batch-wide new tokens.
    ``k=0`` reproduces ``estimate_tps(sched, batch)`` exactly."""
    e_tok = TimingEstimator.expected_accepted_tokens(accept_rate, k)
    t = k * draft_step_s + sched.time_for_tokens(batch * (k + 1))
    return batch * e_tok / max(t, 1e-12)


def choose_spec_k(sched: Schedule, draft_step_s: float,
                  accept_rate: float, k_max: int = 8,
                  batch: int = 1) -> int:
    """Pick the draft window maximizing expected committed TPS
    (DESIGN.md §14). ``k=0`` — plain decode, ``estimate_tps`` — is the
    baseline; a larger k wins only on STRICT improvement, so with a slow
    draft or a low acceptance rate the choice degrades to today's path
    and the whole speculative machinery is a no-op."""
    best_k, best_tps = 0, estimate_tps(sched, batch)
    for k in range(1, k_max + 1):
        tps = estimate_spec_tps(sched, draft_step_s, accept_rate, k, batch)
        if tps > best_tps:
            best_k, best_tps = k, tps
    return best_k
