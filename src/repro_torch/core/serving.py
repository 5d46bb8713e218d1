"""Request-level serving loop (paper inference phase, Step 3/4).

The paper's scheduler is *generic over batches*: each iteration a batch may
contain context-phase chunks of newly admitted requests and one new token
per decode-phase request. The batch-wide new-token count picks the tier
(``PickTier``), whose schedule is set up and executed for everyone at once.

``ContinuousBatcher`` implements that loop over the executor: admit ->
chunked prefill at the tier size -> fused batched decode -> retire.

Decode is *fused* by default: one multi-slot step per iteration takes the
stacked ``(L, B, KV, S, hd)`` caches, a per-slot position vector and the
batch of last tokens, and advances every active slot at once — so each
streamed sub-layer crosses the link exactly once per iteration regardless
of how many slots are in flight. ``fused=False`` keeps the per-slot loop
(one pass per active slot, at the same full-batch shapes with a one-hot
mask) as the baseline the bit-identity tests compare against.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.planner import Schedule
from repro_torch.models.common import greedy_token


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.perf_counter)
    # filled during serving
    generated: list = field(default_factory=list)
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    cancelled_at: Optional[float] = None
    pos: int = 0

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, or ``None`` while no token was emitted."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def done(self):
        return len(self.generated) >= self.max_new_tokens


@dataclass
class TokenEvent:
    """One token emitted by one serve iteration: what an incremental caller
    receives from ``ContinuousBatcher.step()``. ``index`` is the token's
    position in ``request.generated``; ``done`` marks the request's final
    token (its slot is already free)."""
    rid: int
    token: int
    index: int
    done: bool


def random_requests(vocab: int, n: int, prompt_len: int,
                    max_new_tokens: int, seed: int = 0,
                    rid_base: int = 0) -> List[Request]:
    """Uniform-random request batch from a seeded numpy RNG — the same
    prompts as the reference's ``random_requests`` for the same arguments,
    so the two packages serve identical waves."""
    rng = np.random.RandomState(seed)
    return [Request(rid=rid_base + i,
                    prompt=rng.randint(0, vocab, size=prompt_len)
                    .astype(np.int32), max_new_tokens=max_new_tokens)
            for i in range(n)]


class ContinuousBatcher:
    """Serves a stream of requests under a pipelined-sharding schedule.

    Decode slots are fixed at ``max_batch`` (the executor KV layout); new
    requests are admitted into free slots and prefilled with the
    tier-chunked schedule while existing slots keep decoding.
    """

    def __init__(self, cfg, params=None, schedule: Schedule = None,
                 max_batch: int = 4, max_seq: int = 256, fused: bool = True,
                 overlap: bool = True,
                 executor: Optional[PipelinedExecutor] = None,
                 session=None, prefill_mode: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self._session = session
        if executor is not None:
            # share a live executor so a Session can rebind the schedule
            # under this batcher without dropping its KV slots
            if prefill_mode is not None \
                    and prefill_mode != executor.prefill_mode:
                raise ValueError(
                    f"batcher executor runs prefill_mode="
                    f"{executor.prefill_mode!r}; cannot build with "
                    f"{prefill_mode!r} (set it on the Session/executor)")
            self.ex = executor
            self.schedule = executor.schedule
            self.max_seq = executor.max_seq
        else:
            self.schedule = schedule
            self.max_seq = max_seq
            self.ex = PipelinedExecutor(cfg, params, schedule,
                                        max_seq=max_seq, overlap=overlap,
                                        prefill_mode=prefill_mode,
                                        device=device)
        self.device = self.ex.device
        self.max_batch = max_batch
        self.fused = fused
        self.kv = self.ex.init_kv(max_batch)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # the admission queue outlives serve() calls: a paused serve may
        # return before every request found a free slot
        self.pending: List[Request] = []
        self._events: List[TokenEvent] = []
        self.cancelled: List[Request] = []
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.iterations = 0
        self.tier_log = []
        self.completed: List[Request] = []
        # per decode iteration: plan-accounted streamed weight bytes, and
        # actual host->device bytes moved (covers CPU-engine at-use fetches)
        self.iter_streamed_bytes: List[int] = []
        self.iter_moved_bytes: List[int] = []
        self._serve_wall_s = 0.0
        self.rebudget_log: List[dict] = []

    # ------------------------------------------------------------ session
    @classmethod
    def from_session(cls, session, max_batch: int = 4, fused: bool = True):
        """Batcher over a Session's live executor: the session can re-plan
        under it (``session.update_budget`` / ``batcher.rebudget``) — the
        executor swaps pinned weights, never this batcher's KV stacks."""
        return cls(session.cfg, max_batch=max_batch, fused=fused,
                   executor=session.executor, session=session)

    def rebudget(self, new_budget_bytes: int):
        """Re-plan the session under a new VRAM budget between iterations.
        Returns the applied ``ScheduleDiff``; generated tokens are
        unaffected — only weight residency changes."""
        if self._session is None:
            raise RuntimeError("rebudget() needs a session-backed batcher "
                               "(ContinuousBatcher.from_session)")
        diff = self._session.update_budget(new_budget_bytes)
        self.rebudget_log.append({"iteration": self.iterations,
                                  "budget_bytes": new_budget_bytes,
                                  "diff": diff})
        return diff

    def _bind_schedule(self, schedule: Schedule):
        """Adopt a re-planned schedule (tier picks use it from the next
        iteration)."""
        self.schedule = schedule

    # ------------------------------------------------------------ admit
    def _admit(self, queue: List[Request]):
        for i in range(self.max_batch):
            if self.slots[i] is None and queue:
                req = queue.pop(0)
                # validate BEFORE taking the slot
                self._validate(req)
                self.slots[i] = req
                self._prefill_slot(i, req)

    def _validate(self, req: Request):
        T = len(req.prompt)
        if T == 0:
            raise ValueError(f"request {req.rid} has an empty prompt")
        if T + req.max_new_tokens > self.max_seq:
            # past max_seq the cache write start clamps and the validity
            # mask saturates — silently wrong tokens, so reject up front
            raise ValueError(
                f"request {req.rid}: prompt ({T}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq ({self.max_seq})")

    def _prefill_slot(self, slot: int, req: Request):
        """Chunked prefill of one request into its row of the shared KV.
        Layer-major runs the slot-threaded step; chunk-major prefills a
        view of the row, which writes the shared cache in place."""
        T = len(req.prompt)
        tokens = torch.as_tensor(req.prompt, dtype=torch.int32)[None, :]
        n_tiers = len(self.ex.stats.tiers_used)
        if self.ex.prefill_mode == "layer_major":
            logits, _, _ = self.ex.prefill(tokens, kv=self.kv, slot=slot)
        else:
            kv_slot = {"k": self.kv["k"][:, slot:slot + 1],
                       "v": self.kv["v"][:, slot:slot + 1]}
            logits, _, _ = self.ex.prefill(tokens, kv=kv_slot)
        self.tier_log.extend(self.ex.stats.tiers_used[n_tiers:])
        nxt = int(greedy_token(logits[0, -1]))
        req.generated.append(nxt)
        req.first_token_at = time.perf_counter()
        req.pos = T
        self.last_tokens[slot, 0] = nxt
        self._events.append(TokenEvent(req.rid, nxt, len(req.generated) - 1,
                                       req.done))
        # a request whose budget is a single token finishes on its prefill
        # token: retire it here so its slot frees immediately
        if req.done:
            self._retire(slot)

    # ------------------------------------------------------------ retire
    def _retire(self, slot: int):
        req = self.slots[slot]
        req.done_at = time.perf_counter()
        self.completed.append(req)
        self.slots[slot] = None

    # ------------------------------------------------------------ decode
    def _decode_iteration(self):
        """One batched decode step for every active slot (batch-wide new
        token count = #active -> the tier table drives the schedule)."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        before = self.ex.stats.streamed_bytes
        moved_before = self.ex.stats.staged_bytes
        if self.fused:
            self._decode_fused(active)
        else:
            self._decode_per_slot(active)
        self.iter_streamed_bytes.append(self.ex.stats.streamed_bytes - before)
        self.iter_moved_bytes.append(self.ex.stats.staged_bytes
                                     - moved_before)

    def _device_inputs(self, pos_vec, mask):
        dev = self.device
        return (torch.as_tensor(self.last_tokens).to(dev),
                torch.as_tensor(pos_vec).to(dev),
                torch.as_tensor(mask).to(dev))

    def _decode_fused(self, active: List[int]):
        """Fused multi-slot step: every active slot advances one token in a
        single batched pass; streamed sub-layers are fetched once for the
        whole iteration."""
        pos_vec = np.zeros((self.max_batch,), np.int32)
        mask = np.zeros((self.max_batch,), bool)
        for i in active:
            pos_vec[i] = self.slots[i].pos
            mask[i] = True
        self.tier_log.append(self.schedule.pick_decode_tier(len(active)))
        tokens, pos_t, mask_t = self._device_inputs(pos_vec, mask)
        logits, self.kv = self.ex._run_decode(tokens, self.kv, pos_t, mask_t,
                                              n_active=len(active))
        nxt = greedy_token(logits[:, -1]).cpu().numpy()
        for i in active:
            self._advance(i, int(nxt[i]))

    def _decode_per_slot(self, active: List[int]):
        """Baseline: slots decode one at a time, paying the streamed-weight
        copy once per active slot per iteration, each pass at the tier
        picked for its single new token. Each slot runs a one-hot-masked
        pass at the full batch shape — the same shapes as the fused step,
        so the two are bit-identical."""
        pos_vec = np.zeros((self.max_batch,), np.int32)
        for i in active:
            pos_vec[i] = self.slots[i].pos
        for i in active:
            mask = np.zeros((self.max_batch,), bool)
            mask[i] = True
            self.tier_log.append(self.schedule.pick_decode_tier(1))
            tokens, pos_t, mask_t = self._device_inputs(pos_vec, mask)
            logits, self.kv = self.ex._run_decode(tokens, self.kv, pos_t,
                                                  mask_t, n_active=1)
            self._advance(i, int(greedy_token(logits[i, -1])))

    def _advance(self, slot: int, token: int):
        req = self.slots[slot]
        req.generated.append(token)
        req.pos += 1
        self.last_tokens[slot, 0] = token
        self._events.append(TokenEvent(req.rid, token,
                                       len(req.generated) - 1, req.done))
        if req.done:
            self._retire(slot)

    # ------------------------------------------------------------ loop
    @property
    def has_work(self) -> bool:
        """True while a step would make progress (queued or in-flight)."""
        return bool(self.pending) or any(s is not None for s in self.slots)

    def submit(self, requests: List[Request]):
        """Queue requests for admission by the next step."""
        self.pending.extend(requests)

    def step(self) -> List[TokenEvent]:
        """ONE serve iteration — admit into free slots, run one fused
        decode pass — and return the tokens it emitted. ``serve()`` is a
        loop over this, bit-identically."""
        self._events = []
        t0 = time.perf_counter()
        self._admit(self.pending)
        self._decode_iteration()
        self.iterations += 1
        self._serve_wall_s += time.perf_counter() - t0
        return self._events

    def cancel(self, rid: int) -> Optional[str]:
        """Abandon a request mid-flight: a queued request leaves
        ``pending``; an in-flight one is retired WITHOUT a completion and
        its slot frees this instant. Other slots are untouched. Returns
        "queued"/"active", or ``None`` when the rid is unknown."""
        for i, r in enumerate(self.pending):
            if r.rid == rid:
                self.pending.pop(i)
                r.cancelled_at = time.perf_counter()
                self.cancelled.append(r)
                return "queued"
        for slot, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                r.cancelled_at = time.perf_counter()
                self.slots[slot] = None
                self.cancelled.append(r)
                return "active"
        return None

    def serve(self, requests: List[Request], max_iterations: int = 10_000):
        """Admit + decode until the queue drains or ``max_iterations``
        iterations *of this call* have run; a paused serve resumes with
        ``serve([])`` and in-flight slots keep decoding."""
        self.submit(requests)
        start = self.iterations
        while self.has_work and self.iterations - start < max_iterations:
            self.step()
        return requests

    def stats(self):
        done = self.completed
        iters = self.iter_streamed_bytes
        total_generated = sum(len(r.generated) for r in done) \
            + sum(len(r.generated) for r in self.slots if r is not None)
        return {
            "iterations": self.iterations,
            "tiers_used": sorted(set(self.tier_log)),
            "streamed_bytes": self.ex.stats.streamed_bytes,
            "streamed_bytes_by_dtype":
                dict(self.ex.stats.streamed_bytes_by_dtype),
            "engine_calls": dict(self.ex.stats.engine_calls),
            "completed": len(done),
            "cancelled": len(self.cancelled),
            "generated_tokens": total_generated,
            "wall_s": self._serve_wall_s,
            "aggregate_tps": total_generated / max(self._serve_wall_s, 1e-12),
            "mean_ttft_s": (float(np.mean(
                [r.ttft for r in done if r.ttft is not None]))
                if any(r.ttft is not None for r in done) else 0.0),
            "mean_iter_streamed_bytes": (float(np.mean(iters))
                                         if iters else 0.0),
            "mean_iter_moved_bytes": (float(np.mean(self.iter_moved_bytes))
                                      if self.iter_moved_bytes else 0.0),
            "prefill_passes": self.ex.stats.prefill_passes,
            "mean_prefill_streamed_bytes": (
                float(np.mean([p["streamed_bytes"]
                               for p in self.ex.stats.prefill_stats]))
                if self.ex.stats.prefill_stats else 0.0),
            "rebudgets": len(self.rebudget_log),
            "rebind_s": self.ex.stats.rebind_s,
            # expert-granular MoE: how often the routers hit the pinned
            # hot set, and demanded against resident expert bytes
            "expert_hit_rate": self.ex.stats.expert_hit_rate,
            "expert_demanded": self.ex.stats.expert_demanded,
            "demanded_expert_bytes": self.ex.stats.demanded_expert_bytes,
            "resident_expert_bytes": self.ex.stats.resident_expert_bytes,
        }
