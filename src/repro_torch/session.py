"""`repro_torch.Session` — one front door for plan -> install -> serve on
PyTorch, with live re-planning under changing VRAM budgets.

    s = Session.open(cfg, system="h100", budget_bytes=2 << 30)
    tokens = s.generate(prompts, max_new_tokens=16)   # prefill + decode
    s.serve(requests)                                 # continuous batching
    diff = s.update_budget(1 << 30)                   # live re-plan: moves
    s.serve(more)                                     #   only diff bytes

``open`` runs (or reuses) the install-phase profile DB, shards the model
into sub-layers and plans the tier table; the executor, the model
parameters and the continuous batcher are built lazily on first use, so
planning-only sessions never allocate weights.

The port serves dense and MoE decoders greedily with bf16 weights, or with
grouped int8 / packed int4 FFN and expert weights (``cfg.weight_quant``) or
per-expert int8 experts (``cfg.expert_quant``), with stacked or paged KV
(``kv_layout="paged"``: LRU offload of pages to host memory, restores on
demand, prefix reuse) and optional speculative decoding
(``draft_cfg=``, ``spec_k=``: a wholly pinned draft, carved out of the
budget by the planner), on the CUDA card unless the caller passes
``device="cpu"``. MoE models default to
expert-granular placement: the planner pins hot experts one by one
(routing stats seeded from the profile DB, refined online by the
executor's EMA) and the executor streams only the cold experts the
routers select. A hybrid of one mixer a layer (``cfg.layer_pattern``,
nemotron-h: Mamba-2, MLP and attention layers) serves through the same
executor with stacked KV and per-slot Mamba-2 state, unquantised and
without speculation (``open`` raises otherwise). Sessions of the other
families — vlm (qwen2-vl-7b's language stack), audio (musicgen), hybrid
(zamba2) and ssm (xLSTM) — are planning-only, as in the reference: they
build the graph, the schedule and the estimates, and their executor,
batcher, ``generate`` and ``serve`` raise, naming the executor. Those models run through the
monolithic ``Model.prefill`` / ``Model.decode_step``.

``faults=`` (a ``FaultPlan``) injects faults at the named points of the
prefetcher, the executor, the paged cache, the batcher and the gateway;
``recovery=`` (a ``RecoveryPolicy``) sets the retries, the demand deadline
and the worker watchdog's tolerance. An allocation failure walks
``degrade()`` one rung down the ladder (``spec_off``, ``expert_shrink``,
``tier_down``, ``sync``); ``degradation()`` reports where the session
stands. ``gateway()`` puts the OpenAI-compatible async gateway in front of
the session's batcher.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import (SYSTEMS, InferenceSetting, PipelinedExecutor,
                              Schedule, ScheduleDiff, SpecDecoder,
                              SystemConfig, TimingEstimator, build_graph,
                              build_schedule, choose_spec_k,
                              estimate_spec_tps, estimate_tps, estimate_ttft,
                              plan_draft_carve, run_install)
from repro_torch.core.costmodel import kv_block_bytes
from repro_torch.core.executor import resolve_prefill_mode
from repro_torch.core.faults import (DEGRADATION_RUNGS, FaultPlan,
                                     RecoveryPolicy)
from repro_torch.core.kvpaged import PAGE_SIZE
from repro_torch.core.planner import TIERS
from repro_torch.core.serving import ContinuousBatcher, Request
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import greedy_token


def _check_hybrid_serving(cfg, kv_layout, spec_k, draft_cfg):
    """A patterned hybrid serves stacked KV, unquantised weights and plain
    decode: its Mamba-2 state has no pages, no rollback and no int8 or
    int4 form here."""
    if kv_layout == "paged":
        raise ValueError(f"{cfg.name}: a hybrid's recurrent state has no "
                         "pages; serve it with kv_layout='stacked' (the "
                         "paged cache and its prefix cache are for "
                         "attention-only decoders)")
    if spec_k > 0 or draft_cfg is not None:
        raise ValueError(f"{cfg.name}: speculative decoding would roll "
                         "back a hybrid's recurrent state, which cannot "
                         "be undone; serve it with spec_k=0 and no draft")
    if cfg.weight_quant != "fp16" or cfg.expert_quant != "none":
        raise ValueError(f"{cfg.name}: a hybrid's Mamba-2 weights have no "
                         "int8 or int4 form; serve it with "
                         "weight_quant='fp16'")


class Session:
    """Owns profile DB + schedule + executor + batcher for one model on one
    system, and re-plans live when the conditions change."""

    def __init__(self, cfg, system: SystemConfig, budget_bytes: int,
                 setting: InferenceSetting, *, db=None, params=None,
                 wdtype: float = 2.0, max_seq: int = 256, tiers=TIERS,
                 overlap: bool = True, quick_install: bool = True,
                 prefill_mode: Optional[str] = None, device=None,
                 expert_granular: Optional[bool] = None,
                 kv_layout: Optional[str] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pool_pages: Optional[int] = None,
                 draft_cfg=None, draft_params=None, spec_k: int = 0,
                 sampling: str = "greedy",
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None):
        if faults is not None and not isinstance(faults, FaultPlan):
            raise TypeError(f"faults must be a FaultPlan, got "
                            f"{type(faults).__name__}")
        if prefill_mode not in (None, "layer_major", "chunk_major"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if kv_layout not in (None, "stacked", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        # speculative decoding: the reference's raise-early contracts — a
        # combination that would silently give other tokens fails here
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k > 0 and sampling != "greedy":
            raise ValueError(
                f"spec_k={spec_k} requires greedy sampling (got "
                f"sampling={sampling!r}): longest-prefix acceptance is "
                "defined against the target's argmax")
        if sampling != "greedy":
            raise ValueError(f"sampling={sampling!r} is not supported "
                             "(only 'greedy')")
        if cfg.layer_pattern:
            _check_hybrid_serving(cfg, kv_layout, spec_k, draft_cfg)
        if spec_k > 0 and draft_cfg is None:
            raise ValueError("spec_k > 0 needs a draft model "
                             "(Session.open(draft_cfg=...))")
        if draft_cfg is not None:
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft/target vocab mismatch: draft {draft_cfg.name} "
                    f"has vocab={draft_cfg.vocab}, target {cfg.name} has "
                    f"vocab={cfg.vocab}: the draft's token ids would not "
                    "mean the same strings")
            if draft_cfg.tokenizer is not None and cfg.tokenizer is not None \
                    and draft_cfg.tokenizer != cfg.tokenizer:
                raise ValueError(
                    f"draft/target tokenizer mismatch: draft uses "
                    f"{draft_cfg.tokenizer!r}, target uses "
                    f"{cfg.tokenizer!r}: equal vocab sizes do not make the "
                    "id spaces compatible across tokenizers")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.system = system
        self.setting = setting
        self.budget_bytes = budget_bytes
        self.max_seq = max_seq
        self.tiers = tiers
        self.overlap = overlap
        self.prefill_mode = prefill_mode
        self.kv_layout = kv_layout or "stacked"
        self.kv_page_size = int(kv_page_size) if kv_page_size else None
        self.kv_pool_pages = kv_pool_pages
        self.sampling = sampling
        self.draft_cfg = draft_cfg
        self.spec_k = int(spec_k)
        self._draft_params = draft_params
        self.db = db if db is not None else run_install(system,
                                                        quick=quick_install)
        self.est = TimingEstimator(self.db, system)
        # MoE models default to expert-granular placement; an explicit
        # True that cannot be honoured raises rather than being coerced
        if expert_granular is None:
            expert_granular = cfg.moe is not None
        elif expert_granular and cfg.moe is None:
            raise ValueError("expert_granular=True requires an MoE config "
                             f"({cfg.name} has no moe block)")
        self.expert_granular = bool(expert_granular)
        routing = self.db.get_routing(cfg.name) if self.expert_granular \
            else None
        self.subs = build_graph(cfg, wdtype=wdtype,
                                expert_granular=self.expert_granular,
                                routing=routing)
        # the draft carve: with speculation requested the planner first
        # carves the draft's wholly pinned residency out of the budget and
        # the target plans over the rest; infeasible (or spec_k = 0)
        # leaves the target's plan at the full budget, exactly the plan of
        # a session without a draft
        self.draft_subs = build_graph(draft_cfg, wdtype=wdtype) \
            if draft_cfg is not None else None
        self.draft_schedule: Optional[Schedule] = None
        self.draft_carve_bytes = 0
        if self.spec_k > 0:
            self.draft_schedule, self.draft_carve_bytes = plan_draft_carve(
                budget_bytes, self.draft_subs, self.subs, self.est,
                setting, tiers)
        self.schedule: Schedule = build_schedule(
            budget_bytes - self.draft_carve_bytes, self.subs, self.est,
            setting, tiers, kv_page_size=self.kv_page_size or PAGE_SIZE)
        self.replan_log: List[ScheduleDiff] = []
        # fault injection, threaded through the executor into the
        # prefetcher and the paged cache, and the ladder's state: how far
        # an emergency re-budget has walked this session down
        self.faults = faults
        self.recovery = recovery
        self.degradation_level = 0
        self.degrade_log: List[dict] = []
        self._emergency_reserve_bytes = 0
        self._params = params
        self._executor: Optional[PipelinedExecutor] = None
        self._batcher: Optional[ContinuousBatcher] = None
        self._batcher_cfg = None   # (max_batch, fused) as requested
        self._spec_decoder: Optional[SpecDecoder] = None

    # ------------------------------------------------------------ open
    @classmethod
    def open(cls, cfg, system: Union[SystemConfig, str] = "h100",
             budget_bytes: int = 4 << 30,
             setting: Optional[InferenceSetting] = None, **kw) -> "Session":
        """Install (or reuse a profile DB via ``db=``), plan the tier table,
        and return a Session ready to generate/serve. ``system`` accepts a
        ``SystemConfig`` or a name from ``repro_torch.core.SYSTEMS``;
        ``device=None`` is the CUDA card (raises without one), ``"cpu"``
        runs the plain versions on the host."""
        if isinstance(system, str):
            system = SYSTEMS[system]
        return cls(cfg, system, budget_bytes,
                   setting or InferenceSetting(), **kw)

    # ------------------------------------------------------------ lazy build
    @property
    def params(self):
        """The host param tree: the caller's, or random weights from the
        port's own init on a ``torch.Generator`` seeded with 0."""
        if self._params is None:
            gen = torch.Generator().manual_seed(0)
            self._params = build_model(self.cfg).init(gen)
        return self._params

    @property
    def draft_params(self):
        """The draft's host param tree: the caller's (the target's own for
        self-speculation), or random weights seeded with 1 — unlike the
        target's on purpose, so a random draft disagrees with the target
        and exercises the rollback path."""
        if self._draft_params is None and self.draft_cfg is not None:
            gen = torch.Generator().manual_seed(1)
            self._draft_params = build_model(self.draft_cfg).init(gen)
        return self._draft_params

    @property
    def spec_active(self) -> bool:
        """True when speculation is live: requested (spec_k > 0) and the
        current budget fits the draft wholly on the device."""
        return self.spec_k > 0 and self.draft_schedule is not None

    def spec_decoder(self, max_batch: int) -> Optional[SpecDecoder]:
        """The session's draft runner (built on first call while
        speculation is live; ``None`` before). It outlives a re-plan that
        turns speculation off: only the batcher's ``spec_k`` decides
        whether an iteration consults it."""
        if self.spec_active and self._spec_decoder is None:
            self._spec_decoder = SpecDecoder(
                self.draft_cfg, self.draft_params, self.draft_schedule,
                max_batch=max_batch, max_seq=self.max_seq,
                device=self.device)
        return self._spec_decoder

    @property
    def executor(self) -> PipelinedExecutor:
        """The bound executor (built on first use; planning-only sessions
        never construct it)."""
        if self._executor is None:
            if self.cfg.family not in ("dense", "moe") \
                    and not self.cfg.layer_pattern:
                raise NotImplementedError(
                    "the executor runs the dense and moe families and "
                    "hybrids of one mixer a layer; this "
                    f"{self.cfg.family} session is planning-only")
            self._executor = PipelinedExecutor(
                self.cfg, self.params, self.schedule, max_seq=self.max_seq,
                overlap=self.overlap, prefill_mode=self.prefill_mode,
                kv_layout=self.kv_layout, kv_page_size=self.kv_page_size,
                kv_pool_pages=self._effective_kv_pool_pages(),
                device=self.device, faults=self.faults,
                recovery=self.recovery)
        return self._executor

    def _effective_kv_pool_pages(self) -> Optional[int]:
        """The page pool the executor gets: an explicit ``kv_pool_pages``
        wins; otherwise the planner's ``Schedule.kv_pool_bytes`` in pages.
        ``None`` (stacked layout, or a graph with no kv sub-layers) leaves
        the executor's ample, never-evicting default."""
        if self.kv_pool_pages is not None or self.kv_layout != "paged":
            return self.kv_pool_pages
        if self.schedule.kv_pool_bytes <= 0:
            return None
        kv_subs = [s for s in self.subs if s.kind == "kv"]
        if not kv_subs:
            return None
        block = max(kv_block_bytes(s, self.schedule.kv_page_size)
                    for s in kv_subs)
        return max(1, self.schedule.kv_pool_bytes // block)

    def batcher(self, max_batch: Optional[int] = None,
                fused: Optional[bool] = None) -> ContinuousBatcher:
        """The session's continuous batcher. Created on first call (with
        ``max_batch=4, fused=True`` defaults); later calls return the same
        live batcher — ``None`` means "keep as built", and a conflicting
        explicit value raises (the KV layout is fixed at the executor)."""
        if self._batcher is None:
            mb = 4 if max_batch is None else max_batch
            fu = True if fused is None else fused
            self._batcher = ContinuousBatcher.from_session(
                self, max_batch=mb, fused=fu)
            self._batcher_cfg = (mb, fu)
            return self._batcher
        mb_built, fu_built = self._batcher_cfg
        if max_batch is not None and max_batch != mb_built:
            raise ValueError(
                f"session batcher was built with max_batch={mb_built}; "
                f"cannot serve with {max_batch} (close() the session to "
                "rebuild)")
        if fused is not None and fused != fu_built:
            raise ValueError(
                f"session batcher was built with fused={fu_built}; cannot "
                f"serve with fused={fused} (close() the session to "
                "rebuild)")
        return self._batcher

    # ------------------------------------------------------------ inference
    def generate(self, prompts, max_new_tokens: int = 8) -> np.ndarray:
        """Greedy batch generation: chunked prefill at the planner-picked
        tier, then decode. prompts: (B, T) int tokens; returns (B,
        max_new_tokens) numpy tokens."""
        ex = self.executor
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32)
        last, kv, pos = ex.prefill(tokens)
        gen, _ = ex.decode(greedy_token(last), kv, pos,
                           steps=max_new_tokens)
        return gen

    def serve(self, requests: List[Request],
              max_batch: Optional[int] = None, fused: Optional[bool] = None,
              max_iterations: int = 10_000):
        """Continuous batching through the session's executor. Repeated
        calls reuse the same batcher, so a paused serve (``max_iterations``)
        can be resumed — across ``update_budget`` swaps — without losing
        in-flight slots."""
        b = self.batcher(max_batch=max_batch, fused=fused)
        return b.serve(requests, max_iterations=max_iterations)

    def gateway(self, **kw):
        """An OpenAI-compatible async serving gateway over this session's
        batcher; keyword arguments go to ``Gateway`` (queue bound, rate
        limits, queue-aware tier hints)."""
        from repro_torch.gateway.server import Gateway   # import cycle
        return Gateway(session=self, **kw)

    # ------------------------------------------------------------ re-plan
    def update_budget(self, new_budget_bytes: int) -> ScheduleDiff:
        """Re-plan under a new VRAM budget and apply the delta live.
        Returns the ``Schedule.diff`` whose pin/evict bytes are exactly what
        the executor moved."""
        return self._replan(budget_bytes=new_budget_bytes)

    def update_setting(self, **changes) -> ScheduleDiff:
        """Re-plan under changed inference conditions (batch, context,
        dtypes — any ``InferenceSetting`` field) and apply the delta live."""
        return self._replan(setting=replace(self.setting, **changes))

    def _refresh_routing_stats(self):
        """Fold the executor's online routing EMA back into the profile DB
        and the expert shards' ``hot`` metadata, so the next plan pins the
        observed hot set rather than the seeded one."""
        if not self.expert_granular or self._executor is None:
            return
        ema = self._executor.expert_ema
        for layer, freqs in ema.items():
            self.db.set_routing(self.cfg.name, layer, freqs)
        for s in self.subs:
            if s.kind == "moe_expert" and s.layer in ema:
                s.meta["hot"] = float(ema[s.layer][s.meta["expert"]])

    def _replan(self, budget_bytes: Optional[int] = None,
                setting: Optional[InferenceSetting] = None) -> ScheduleDiff:
        if budget_bytes is not None:
            self.budget_bytes = budget_bytes
        if setting is not None:
            self.setting = setting
        self._refresh_routing_stats()
        # re-check the draft carve under the new conditions: a shrunk
        # budget that no longer fits the draft turns speculation off (the
        # target re-plans at the full budget), a later growth turns it on
        if self.spec_k > 0:
            self.draft_schedule, self.draft_carve_bytes = plan_draft_carve(
                self.budget_bytes - self._emergency_reserve_bytes,
                self.draft_subs, self.subs, self.est, self.setting,
                self.tiers)
        new = build_schedule(self.budget_bytes - self.draft_carve_bytes
                             - self._emergency_reserve_bytes,
                             self.subs, self.est, self.setting, self.tiers,
                             kv_page_size=self.kv_page_size or PAGE_SIZE)
        diff = self.schedule.diff(new)
        if self._executor is not None:
            report = self._executor.rebind(new)
            if report["pinned_bytes"] != diff.pin_bytes \
                    or report["evicted_bytes"] != diff.evict_bytes:
                raise RuntimeError("executor rebind moved different bytes "
                                   "than Schedule.diff")
        if self._batcher is not None:
            self._batcher._bind_schedule(new)
            self._batcher._bind_spec(
                self.spec_decoder(self._batcher.max_batch),
                self.spec_k if self.spec_active else 0)
        self.schedule = new
        self.replan_log.append(diff)
        return diff

    # ------------------------------------------------------------ ladder
    def degrade(self, reason: str = "") -> Optional[int]:
        """Walk one applicable rung down the emergency re-budget ladder in
        answer to an allocation failure, and return the new level, or
        ``None`` once the ladder is exhausted. Rungs, mildest first:

          1. ``spec_off``      — drop the draft carve, its weights and KV
          2. ``expert_shrink`` — veto the colder half of the expert hot set
          3. ``tier_down``     — cut the tier table and hold back an
                                 emergency reserve of budget // 4
          4. ``sync``          — overlap off: every pass runs the
                                 synchronous path, no staging slots

        A rung changes residency or overlap, never a computed value, so the
        tokens do not change. A rung that does nothing for this session
        (a dense model, speculation off) is passed over without being
        reported. After a rung the card's cached blocks are released, so
        what the rung freed is free for other programs too."""
        while self.degradation_level < len(DEGRADATION_RUNGS) - 1:
            nxt = self.degradation_level + 1
            rung = DEGRADATION_RUNGS[nxt]
            applied = getattr(self, f"_rung_{rung}")()
            self.degradation_level = nxt
            if applied:
                self.degrade_log.append({"level": nxt, "rung": rung,
                                         "reason": reason})
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                return nxt
        return None

    def _rung_spec_off(self) -> bool:
        if self.spec_k <= 0:
            return False
        # _replan re-carves only while spec_k > 0: clear the carve here,
        # and drop the draft (its executor, weights and KV cache)
        self.spec_k = 0
        self.draft_schedule = None
        self.draft_carve_bytes = 0
        self._spec_decoder = None
        self._replan()
        return True

    def _rung_expert_shrink(self) -> bool:
        if not self.expert_granular:
            return False
        cands = sorted((s for s in self.subs if s.kind == "moe_expert"
                        and not s.meta.get("pin_veto")),
                       key=lambda s: s.meta.get("hot", 0.0))
        if len(cands) < 2:
            return False
        for s in cands[:len(cands) // 2]:
            s.meta["pin_veto"] = True
        self._replan()
        return True

    def _rung_tier_down(self) -> bool:
        ts = tuple(sorted(self.tiers))
        cap = max(ts[0], ts[-1] // 4)
        new = tuple(t for t in ts if t <= cap)
        reserve = self.budget_bytes // 4
        if new == ts and reserve <= self._emergency_reserve_bytes:
            return False
        self.tiers = new
        self._emergency_reserve_bytes = max(reserve,
                                            self._emergency_reserve_bytes)
        self._replan()
        return True

    def _rung_sync(self) -> bool:
        # a parked executor stages nothing: its prefetcher holds no slot
        # and no demand buffer between passes
        ex = self._executor
        applied = False
        if ex is not None:
            if ex.prefetch is not None and not ex.stats.degraded_sync:
                ex.stats.degraded_sync = True
                applied = True
        elif self.overlap:
            applied = True
        self.overlap = False
        return applied

    def note_executor_degraded(self):
        """Record a sync degrade the worker watchdog forced: the executor
        parked itself on the synchronous path after a prefetch worker
        died, so the session stands at the last rung. Idempotent."""
        terminal = len(DEGRADATION_RUNGS) - 1
        if self.degradation_level >= terminal:
            return
        self.degradation_level = terminal
        self.overlap = False
        self.degrade_log.append({"level": terminal, "rung": "sync",
                                 "reason": "prefetch worker watchdog"})

    def degradation(self) -> dict:
        """The ladder's position and the fault and recovery counters: what
        ``stats()`` embeds and the gateway's /healthz and /metrics
        report."""
        out = {"level": self.degradation_level,
               "rung": DEGRADATION_RUNGS[self.degradation_level],
               "log": list(self.degrade_log)}
        if self._executor is not None:
            ex = self._executor.stats
            out.update({
                "copy_retries": ex.fault_copy_retries,
                "copy_failures": ex.fault_copy_failures,
                "worker_crashes": ex.fault_worker_crashes,
                "demand_timeouts": ex.fault_demand_timeouts,
                "sync_fallbacks": ex.fault_sync_fallbacks,
                "alloc_failures": ex.fault_alloc_failures,
                "degraded_sync": ex.degraded_sync,
            })
        if self.faults is not None:
            out["injected"] = self.faults.counters()
        return out

    @property
    def effective_prefill_mode(self) -> str:
        return resolve_prefill_mode(self.prefill_mode)

    # ------------------------------------------------------------ estimates
    def estimates(self, isl: Optional[int] = None,
                  prefix_hit_frac: float = 0.0) -> dict:
        """Planner-side TTFT/TPS estimates for the bound conditions; the
        TTFT model follows the session's prefill mode. ``prefix_hit_frac``
        feeds the prefix-cache term of the TTFT model (paged sessions
        only). A live speculative session adds a ``spec`` block: the
        draft's step time, the acceptance rate (the executor's observed
        one once a verify pass ran, else 0.7), the speculative tok/s and
        the window ``choose_spec_k`` would pick."""
        if prefix_hit_frac and self.kv_layout != "paged":
            raise ValueError("prefix_hit_frac needs kv_layout='paged' — the "
                             "stacked cache has no prefix cache")
        isl = isl if isl is not None else self.setting.context
        out = {"ttft_s": estimate_ttft(self.schedule, isl,
                                       mode=self.effective_prefill_mode,
                                       prefix_hit_frac=prefix_hit_frac),
               "tps": estimate_tps(self.schedule, self.setting.batch),
               "pinned_bytes": self.schedule.pinned_bytes,
               "scratch_bytes": self.schedule.scratch_bytes,
               "kv_pool_bytes": self.schedule.kv_pool_bytes}
        if self.spec_active:
            batch = self.setting.batch
            draft_step_s = self.draft_schedule.time_for_tokens(batch)
            a = self._observed_accept_rate(default=0.7)
            out["spec"] = {
                "spec_k": self.spec_k,
                "draft_carve_bytes": self.draft_carve_bytes,
                "draft_step_s": draft_step_s,
                "accept_rate": a,
                "spec_tps": estimate_spec_tps(self.schedule, draft_step_s,
                                              a, self.spec_k, batch),
                "chosen_k": choose_spec_k(self.schedule, draft_step_s, a,
                                          batch=batch),
            }
        return out

    def _observed_accept_rate(self, default: float = 0.7) -> float:
        """The executor's measured acceptance rate, or ``default`` before
        any speculative iteration ran."""
        if self._executor is not None \
                and self._executor.stats.spec_drafted > 0:
            return self._executor.stats.accept_rate
        return default

    def stats(self) -> dict:
        """Lifecycle stats: planning + (if built) executor + batcher."""
        out = {"budget_bytes": self.budget_bytes,
               "system": self.system.name,
               "device": str(self.device),
               "replans": len(self.replan_log),
               "weight_quant": self.cfg.weight_quant,
               "pinned_bytes": self.schedule.pinned_bytes,
               "scratch_bytes": self.schedule.scratch_bytes,
               "kv_layout": self.kv_layout,
               "kv_pool_bytes": self.schedule.kv_pool_bytes,
               "spec_k": self.spec_k,
               "spec_active": self.spec_active,
               "draft_carve_bytes": self.draft_carve_bytes}
        if self._executor is not None:
            ex = self._executor.stats
            pf = ex.prefill_stats
            out["executor"] = {
                "streamed_bytes": ex.streamed_bytes,
                "streamed_bytes_by_dtype": dict(ex.streamed_bytes_by_dtype),
                "staged_bytes": ex.staged_bytes,
                "engine_calls": dict(ex.engine_calls),
                "at_use_bytes": ex.at_use_bytes,
                "prefill_passes": ex.prefill_passes,
                "prefills": len(pf),
                "prefill_streamed_bytes_per_prompt": (
                    float(np.mean([p["streamed_bytes"] for p in pf]))
                    if pf else 0.0),
                "prefill_stats": list(pf),
                "rebinds": ex.rebinds,
                "rebind_pinned_bytes": ex.rebind_pinned_bytes,
                "rebind_evicted_bytes": ex.rebind_evicted_bytes,
                "rebind_s": ex.rebind_s,
            }
            if self.expert_granular:
                out["executor"].update({
                    "expert_hit_rate": ex.expert_hit_rate,
                    "expert_demanded": ex.expert_demanded,
                    "demanded_expert_bytes": ex.demanded_expert_bytes,
                    "resident_expert_bytes": ex.resident_expert_bytes,
                })
            if self.kv_layout == "paged":
                out["executor"].update({
                    "page_faults": ex.page_faults,
                    "demanded_page_bytes": ex.demanded_page_bytes,
                })
        out["degradation"] = self.degradation()
        if self._batcher is not None:
            out["serving"] = self._batcher.stats()
        return out

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Drop executor/batcher references (device tensors become
        collectable); the session stays usable for planning."""
        self._batcher = None
        self._batcher_cfg = None
        self._executor = None
        self._spec_decoder = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
