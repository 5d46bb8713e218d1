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
per-expert int8 experts (``cfg.expert_quant``), and stacked KV, on the CUDA
card unless the caller passes ``device="cpu"``. MoE models default to
expert-granular placement: the planner pins hot experts one by one
(routing stats seeded from the profile DB, refined online by the
executor's EMA) and the executor streams only the cold experts the
routers select. A vlm session
(qwen2-vl-7b's language stack) is planning-only, as in the reference: it
builds the graph, the schedule and the estimates, and its executor,
batcher, ``generate`` and ``serve`` raise. The reference's other options
raise ``NotImplementedError`` naming the slice of the port they belong to.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core import (SYSTEMS, InferenceSetting, PipelinedExecutor,
                              Schedule, ScheduleDiff, SystemConfig,
                              TimingEstimator, build_graph, build_schedule,
                              estimate_tps, estimate_ttft, run_install)
from repro_torch.core.executor import resolve_prefill_mode
from repro_torch.core.planner import TIERS
from repro_torch.core.serving import ContinuousBatcher, Request
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import greedy_token


def _not_ported(option: str, slice_name: str):
    raise NotImplementedError(f"{option} is not ported yet: it lands with "
                              f"the {slice_name} slice of the port")


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
                 draft_cfg=None, spec_k: int = 0, faults=None):
        if cfg.family not in ("dense", "moe", "vlm"):
            _not_ported(f"family={cfg.family!r}",
                        "audio / SSM / hybrid model")
        if kv_layout not in (None, "stacked"):
            if kv_layout == "paged":
                _not_ported("kv_layout='paged'", "paged-KV")
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if draft_cfg is not None or spec_k:
            _not_ported("speculative decoding (draft_cfg, spec_k)",
                        "speculative-decoding")
        if faults is not None:
            _not_ported("fault injection (faults)", "faults")
        if prefill_mode not in (None, "layer_major", "chunk_major"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.system = system
        self.setting = setting
        self.budget_bytes = budget_bytes
        self.max_seq = max_seq
        self.tiers = tiers
        self.overlap = overlap
        self.prefill_mode = prefill_mode
        self.kv_layout = "stacked"
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
        self.schedule: Schedule = build_schedule(budget_bytes, self.subs,
                                                 self.est, setting, tiers)
        self.replan_log: List[ScheduleDiff] = []
        self._params = params
        self._executor: Optional[PipelinedExecutor] = None
        self._batcher: Optional[ContinuousBatcher] = None
        self._batcher_cfg = None   # (max_batch, fused) as requested

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
    def executor(self) -> PipelinedExecutor:
        """The bound executor (built on first use; planning-only sessions
        never construct it)."""
        if self._executor is None:
            if self.cfg.family not in ("dense", "moe"):
                raise NotImplementedError(
                    "the executor runs the dense and moe families; this "
                    f"{self.cfg.family} session is planning-only")
            self._executor = PipelinedExecutor(
                self.cfg, self.params, self.schedule, max_seq=self.max_seq,
                overlap=self.overlap, prefill_mode=self.prefill_mode,
                device=self.device)
        return self._executor

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
        _not_ported("gateway()", "gateway")

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
        new = build_schedule(self.budget_bytes, self.subs, self.est,
                             self.setting, self.tiers)
        diff = self.schedule.diff(new)
        if self._executor is not None:
            report = self._executor.rebind(new)
            if report["pinned_bytes"] != diff.pin_bytes \
                    or report["evicted_bytes"] != diff.evict_bytes:
                raise RuntimeError("executor rebind moved different bytes "
                                   "than Schedule.diff")
        if self._batcher is not None:
            self._batcher._bind_schedule(new)
        self.schedule = new
        self.replan_log.append(diff)
        return diff

    @property
    def effective_prefill_mode(self) -> str:
        return resolve_prefill_mode(self.prefill_mode)

    # ------------------------------------------------------------ estimates
    def estimates(self, isl: Optional[int] = None) -> dict:
        """Planner-side TTFT/TPS estimates for the bound conditions; the
        TTFT model follows the session's prefill mode."""
        isl = isl if isl is not None else self.setting.context
        return {"ttft_s": estimate_ttft(self.schedule, isl,
                                        mode=self.effective_prefill_mode),
                "tps": estimate_tps(self.schedule, self.setting.batch),
                "pinned_bytes": self.schedule.pinned_bytes,
                "scratch_bytes": self.schedule.scratch_bytes,
                "kv_pool_bytes": self.schedule.kv_pool_bytes}

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
               "kv_pool_bytes": self.schedule.kv_pool_bytes}
        if self._executor is not None:
            ex = self._executor.stats
            pf = ex.prefill_stats
            out["executor"] = {
                "streamed_bytes": ex.streamed_bytes,
                "streamed_bytes_by_dtype": dict(ex.streamed_bytes_by_dtype),
                "staged_bytes": ex.staged_bytes,
                "engine_calls": dict(ex.engine_calls),
                "copy_s_hidden": ex.copy_s_hidden,
                "copy_s_exposed": ex.copy_s_exposed,
                "at_use_bytes": ex.at_use_bytes,
                "at_use_s": ex.at_use_s,
                "prefill_passes": ex.prefill_passes,
                "prefills": len(pf),
                "prefill_streamed_bytes_per_prompt": (
                    float(np.mean([p["streamed_bytes"] for p in pf]))
                    if pf else 0.0),
                "prefill_copy_s_hidden": sum(p["copy_s_hidden"]
                                             for p in pf),
                "prefill_copy_s_exposed": sum(p["copy_s_exposed"]
                                              for p in pf),
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

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
