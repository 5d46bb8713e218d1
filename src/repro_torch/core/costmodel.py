"""Profile-driven roofline timing estimator (paper §4, "Profiler-based
timing estimation for schedule plans").

For every kernel of every sub-layer: exact profile match -> achieved FLOPS;
partial match -> nearest neighbour + roofline classification (compute-bound:
flops/FLOPS_roofline; memory-bound: bytes/bandwidth); no match -> skipped.

Plan time uses the pipelined copy-compute recurrence:
    link_done[j] = link_done[j-1] + transfer[j]
    ready[j]     = max(finish[j-1], link_done[j])
    finish[j]    = ready[j] + compute[j]
i.e. transfers for shard j overlap earlier shards' compute (the paper's VRAM
scratch double-buffer), and the serial dependency chain is respected.

CPU/link contention: when a plan keeps the link busy a significant fraction
of the pass, CPU kernels are costed with the pcie_active profile entries
(the paper's contention-aware measurements).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.profile_db import ProfileDB
from repro_torch.core.sublayer import STREAMABLE_KINDS, SubLayer
from repro_torch.core.system import InferenceSetting, SystemConfig


@dataclass
class Placement:
    sub: SubLayer
    residency: str   # "vram" | "sysram"
    engine: str      # "gpu" | "cpu"
    streamed: bool = False  # weights copied just-in-time to VRAM scratch

    def short(self):
        return f"{self.sub.name}:{self.residency[0]}{self.engine[0]}" \
               f"{'s' if self.streamed else ''}"


def kv_block_bytes(kv_sub: SubLayer, page_size: int) -> int:
    """Bytes of ONE paged-KV block of this layer's cache — ``page_size``
    tokens across BOTH cache sides (``kv_bytes_per_token`` already covers
    k + v). The planner sizes the page pool in these units, and the
    executor's ``kvpage`` demand shards carry exactly this weight_bytes
    (DESIGN.md §12)."""
    return kv_sub.kv_bytes_per_token * page_size


@dataclass
class Plan:
    name: str
    placements: List[Placement]
    est_time: float = 0.0
    detail: dict = field(default_factory=dict)

    def stream_order(self) -> List[Placement]:
        """Streamed compute sub-layers in execution order — the exact queue
        the weight-prefetch engine walks (placements are emitted in the
        model's execution order by ``build_graph``)."""
        return [p for p in self.placements
                if p.streamed and p.engine == "gpu"
                and p.sub.kind in STREAMABLE_KINDS]

    def static_stream_order(self) -> List[Placement]:
        """The pass-static part of ``stream_order``: everything except
        ``moe_expert`` shards, which are demand-streamed — fetched only
        when the router selects them, mid-pass (DESIGN.md §9)."""
        return [p for p in self.stream_order()
                if p.sub.kind != "moe_expert"]

    def streamed_expert_placements(self) -> List[Placement]:
        """Cold (streamed) expert shards — the demand-stream candidate set;
        per pass only the router-selected subset actually crosses the
        link."""
        return [p for p in self.stream_order()
                if p.sub.kind == "moe_expert"]

    def streamed_weight_bytes(self) -> int:
        """Plan-accounted bytes one full pass streams across the link.
        For expert-granular plans this is the WORST case (every cold
        expert demanded); a decode step's actual traffic is
        ``static_stream_order`` bytes plus the demanded experts only."""
        return sum(p.sub.weight_bytes for p in self.stream_order())

    def streamed_weight_bytes_by_dtype(self) -> dict:
        """``streamed_weight_bytes`` split by each shard's storage format
        (``meta["quant"]``: fp16 / int8 / int4) — the plan-side counterpart
        of ``ExecStats.streamed_bytes_by_dtype`` (DESIGN.md §11)."""
        out: dict = {}
        for p in self.stream_order():
            q = p.sub.meta.get("quant", "fp16")
            out[q] = out.get(q, 0) + p.sub.weight_bytes
        return out


class TimingEstimator:
    def __init__(self, db: ProfileDB, system: SystemConfig,
                 threads: Optional[int] = None):
        self.db = db
        self.sys = system
        self.threads = threads if threads is not None else system.cpu_threads
        self.match_stats = {"exact": 0, "partial": 0, "skipped": 0}

    # ------------------------------------------------------------ kernels
    def kernel_time(self, engine: str, kern, pcie_active: bool = False) -> float:
        th = self.threads if engine == "cpu" else 0
        hit = self.db.lookup(engine, kern.op, kern.dtype_bytes, th, kern.dims,
                             pcie_active=pcie_active and engine == "cpu")
        if hit is None:
            self.match_stats["skipped"] += 1
            return 0.0
        entry, match = hit
        self.match_stats[match] += 1
        if match == "exact":
            return kern.flops / (entry.gflops * 1e9)
        # roofline classification against the neighbour's achieved point
        ai = kern.flops / max(kern.bytes, 1.0)
        knee = entry.gflops / max(entry.gbps, 1e-9)
        if ai >= knee:
            return kern.flops / (entry.gflops * 1e9)
        return kern.bytes / (entry.gbps * 1e9)

    def sublayer_compute(self, sub: SubLayer, engine: str, new_tokens: int,
                         setting: InferenceSetting,
                         pcie_active: bool = False) -> float:
        ks = sub.kernels(new_tokens, setting.context, setting.batch)
        return sum(self.kernel_time(engine, k, pcie_active) for k in ks)

    # ------------------------------------------------------------ plans
    @staticmethod
    def demand_probability(sub: SubLayer, new_tokens: int) -> float:
        """P(a cold expert shard is demanded in a pass of ``new_tokens``)
        from its routing frequency: per token the expert is selected with
        probability ~``min(1, top_k * hot)``, so over t independent tokens
        P(demanded) = 1 - (1 - q)^t. Prefill chunks drive this to ~1 (all
        experts touched), decode steps to ~top_k/E — exactly the
        used-bytes-vs-resident-bytes gap demand streaming exploits
        (DESIGN.md §9)."""
        m = sub.meta
        q = min(1.0, m["top_k"] * m.get("hot", 1.0 / m["E"]))
        return 1.0 - (1.0 - q) ** max(1, new_tokens)

    def _transfer_bytes(self, pl: Placement, plan: Plan, setting,
                        new_tokens: int = 1,
                        include_streamed_weights: bool = True) -> float:
        """Per-iteration link traffic caused by this placement.

        ``include_streamed_weights=False`` drops the streamed-weight term
        and keeps only the per-pass traffic that repeats every chunk (KV
        residency, boundary hops are added by the caller) — the repeat
        cost of a layer-major weight-stationary prefill chunk, where each
        streamed shard crosses the link once per prompt (DESIGN.md §10).
        """
        bytes_ = 0.0
        if include_streamed_weights and pl.streamed and pl.engine == "gpu":
            w = pl.sub.weight_bytes
            if pl.sub.kind == "moe_expert":
                w *= self.demand_probability(pl.sub, new_tokens)
            bytes_ += w
        if pl.sub.kind == "kv":
            # KV in sysram but attention on GPU -> stream cache across link
            attn = self._attn_of(pl, plan)
            if attn is not None and attn.engine == "gpu" \
                    and pl.residency == "sysram":
                bytes_ += pl.sub.bytes_resident(setting)
        return bytes_

    @staticmethod
    def _attn_of(kv_pl: Placement, plan: Plan):
        for p in plan.placements:
            if p.sub.layer == kv_pl.sub.layer and p.sub.kind == "attn" \
                    and p.sub.name.rsplit("/", 1)[0] == kv_pl.sub.name.rsplit("/", 1)[0]:
                return p
        return None

    def _boundary_bytes(self, prev: Optional[Placement], cur: Placement,
                        new_tokens: int) -> float:
        """Activation hop when execution engine changes (paper Plan Static)."""
        if prev is None or prev.engine == cur.engine:
            return 0.0
        d = cur.sub.meta.get("d") or prev.sub.meta.get("d") or 0
        return 2.0 * new_tokens * d

    def plan_time(self, plan: Plan, new_tokens: int,
                  setting: InferenceSetting,
                  include_streamed_weights: bool = True) -> float:
        """Pipelined copy-compute pass time. With
        ``include_streamed_weights=False`` the streamed weight bytes are
        excluded: that is the cost of one *repeat* chunk of a layer-major
        prefill, whose weights are already resident from the pass's single
        streaming sweep (DESIGN.md §10)."""
        link_bw = self.sys.link_gbps * 1e9
        # first pass: will the link be busy? (contention decision)
        total_xfer = sum(
            self._transfer_bytes(p, plan, setting, new_tokens,
                                 include_streamed_weights)
            for p in plan.placements)
        rough_compute = sum(
            self.sublayer_compute(p.sub, p.engine, new_tokens, setting)
            for p in plan.placements if p.sub.kind != "kv")
        pcie_busy = (total_xfer / link_bw) > 0.3 * max(rough_compute, 1e-9)

        link_done = 0.0
        finish = 0.0
        compute_total = {"gpu": 0.0, "cpu": 0.0}
        prev = None
        for p in plan.placements:
            xfer = self._transfer_bytes(p, plan, setting, new_tokens,
                                        include_streamed_weights) \
                + self._boundary_bytes(prev, p, new_tokens)
            link_done += xfer / link_bw
            c = 0.0
            if p.sub.kind != "kv":
                c = self.sublayer_compute(p.sub, p.engine, new_tokens, setting,
                                          pcie_active=pcie_busy)
                compute_total[p.engine] += c
            ready = max(finish, link_done)
            finish = ready + c
            prev = p
        plan.detail = {"xfer_s": link_done, "gpu_s": compute_total["gpu"],
                       "cpu_s": compute_total["cpu"], "pcie_busy": pcie_busy}
        return finish

    # ------------------------------------------------------ speculation
    @staticmethod
    def expected_accepted_tokens(accept_rate: float, k: int) -> float:
        """Expected committed tokens per verify pass of width ``k+1``
        under i.i.d. per-position acceptance probability ``accept_rate``
        (DESIGN.md §14): the truncated-geometric mean

            E[tokens] = (1 - a^(k+1)) / (1 - a)

        counting the bonus token the target always supplies. ``k=0``
        gives exactly 1 — plain decode — so the speculative model
        degrades to the current one by construction."""
        a = min(max(accept_rate, 0.0), 1.0)
        if a >= 1.0:
            return float(k + 1)
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def spec_iteration_time(self, plan: Plan, batch: int,
                            setting: InferenceSetting, k: int,
                            draft_step_s: float) -> float:
        """One speculative iteration under ``plan``: ``k`` sequential
        draft steps (the VRAM-pinned draft, no streamed bytes) plus ONE
        verify pass whose batch-wide new-token count is
        ``batch * (k+1)`` — the streamed weights cross the link once for
        the whole window (DESIGN.md §14). ``k=0`` degrades exactly to
        ``plan_time(plan, batch)``, today's decode estimate."""
        return k * draft_step_s + self.plan_time(plan, batch * (k + 1),
                                                 setting)
