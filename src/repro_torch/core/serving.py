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

With ``kv_layout="paged"`` the caches are a ``PagedKVCache``: admission
maps pages (and cached prompt prefixes) inside ``executor.prefill``, and
retiring or cancelling a request unmaps its pages. With a ``SpecDecoder``
and ``spec_k > 0`` each decode iteration drafts ``k`` tokens per slot on
the pinned draft, verifies them in one streamed target pass, commits the
longest accepted prefix plus the target's bonus token and rolls back the
rejected KV suffix (``_decode_spec``): the tokens equal plain greedy
decode's.

Faults (``core/faults.py``): a request whose servicing raises fails alone
(``_fail_slot``: an error event, its slot and pages freed), and the other
slots' tokens do not change; an allocation failure (an injected
``alloc.device`` / ``alloc.host``, or a real ``PagePoolFull``) walks the
owning session one rung down the degradation ladder and re-runs the
admission or the iteration, which aborted before any KV write. A handled
fault's traceback is dropped (``prefetch.drop_traceback``): it would keep
the frames of the pass it aborted, and what they hold, alive.
``set_queue_pressure`` feeds a caller's queue depth and deadline slack
into the tier picks (the gateway does, each pump turn).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.faults import AllocationFault
from repro_torch.core.kvpaged import PagedKVCache, PagePoolFull
from repro_torch.core.prefetch import drop_traceback
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
    error: Optional[str] = None   # set when servicing this request failed
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
    token (its slot is already free). ``error`` marks a failed request's
    terminal event instead of a token: ``token`` is -1 and ``done`` True,
    and only this rid's client is affected."""
    rid: int
    token: int
    index: int
    done: bool
    error: Optional[str] = None


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
                 kv_layout: str = "stacked",
                 kv_page_size: Optional[int] = None,
                 kv_pool_pages: Optional[int] = None,
                 spec=None, spec_k: int = 0, device=None):
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
            if kv_layout != "stacked" and kv_layout != executor.kv_layout:
                raise ValueError(
                    f"batcher executor runs kv_layout="
                    f"{executor.kv_layout!r}; cannot build with "
                    f"{kv_layout!r} (set it on the Session/executor)")
            self.ex = executor
            self.schedule = executor.schedule
            self.max_seq = executor.max_seq
        else:
            self.schedule = schedule
            self.max_seq = max_seq
            self.ex = PipelinedExecutor(cfg, params, schedule,
                                        max_seq=max_seq, overlap=overlap,
                                        prefill_mode=prefill_mode,
                                        kv_layout=kv_layout,
                                        kv_page_size=kv_page_size,
                                        kv_pool_pages=kv_pool_pages,
                                        device=device)
        self.device = self.ex.device
        self.max_batch = max_batch
        self.fused = fused
        # speculative decoding: a SpecDecoder drafting spec_k tokens per
        # iteration for the fused verify pass; spec_k = 0 (or no decoder)
        # keeps every iteration a plain fused step
        self.spec = spec
        self.spec_k = spec_k if spec is not None and fused else 0
        self.kv = self.ex.init_kv(max_batch)
        self._paged = isinstance(self.kv, PagedKVCache)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # the admission queue outlives serve() calls: a paused serve may
        # return before every request found a free slot
        self.pending: List[Request] = []
        self._events: List[TokenEvent] = []
        self.cancelled: List[Request] = []
        # live queue-pressure hints for the tier picks: off until
        # set_queue_pressure turns them on
        self._queue_aware = False
        self._queue_depth = 0
        self._slack_s: Optional[float] = None
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.iterations = 0
        self.tier_log = []
        self.completed: List[Request] = []
        # requests failed alone, and ladder rungs taken under this
        # batcher: both empty on a clean serve
        self.failed: List[Request] = []
        self.degradations: List[dict] = []
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
                   executor=session.executor, session=session,
                   spec=session.spec_decoder(max_batch),
                   spec_k=session.spec_k if session.spec_active else 0)

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

    def _bind_spec(self, spec, spec_k: int):
        """Adopt the session's re-checked speculation state after a
        re-plan: a shrunk budget that no longer fits the draft turns
        speculation off (the next iteration is a plain fused step, with
        the same tokens), and a later growth turns it back on against the
        draft's still-live KV."""
        self.spec = spec
        self.spec_k = spec_k if spec is not None and self.fused else 0

    # ------------------------------------------------------------ admit
    def _admit(self, queue: List[Request]):
        for i in range(self.max_batch):
            if self.slots[i] is None and queue:
                req = queue.pop(0)
                # validate BEFORE taking the slot
                self._validate(req)
                self.slots[i] = req
                self._prefill_guard(i, req)

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
        Layer-major runs the slot-threaded step (a paged cache maps pages
        and looks up the prefix cache there); chunk-major prefills a view
        of the row (the KV's, and a hybrid's state), which writes the
        shared cache in place. A hybrid's recurrent state is zeroed first:
        the slot's last request left its own there."""
        T = len(req.prompt)
        tokens = torch.as_tensor(req.prompt, dtype=torch.int32)[None, :]
        n_tiers = len(self.ex.stats.tiers_used)
        if self.ex.has_state:
            self.ex.reset_state(self.kv, slot)
        if self._paged or self.ex.prefill_mode == "layer_major":
            logits, _, _ = self.ex.prefill(tokens, kv=self.kv, slot=slot)
        else:
            kv_slot = {k: v[:, slot:slot + 1] for k, v in self.kv.items()}
            logits, _, _ = self.ex.prefill(tokens, kv=kv_slot)
        self.tier_log.extend(self.ex.stats.tiers_used[n_tiers:])
        if self.spec is not None:
            # the draft's KV slot follows the target's; kept while spec_k
            # is 0 (a re-plan turned it off) so a later re-enable finds
            # the prompt in place
            self.spec.prefill_slot(slot, req.prompt)
        nxt = int(trace.to_host(greedy_token(logits[0, -1]), "first_token"))
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

    def _prefill_guard(self, slot: int, req: Request):
        """Admission under fault protection. An allocation failure walks
        the session one rung down the ladder and re-runs the prefill,
        after unmapping the pages the failed attempt attached. Any other
        error fails this request alone; a ``ValueError`` (a contract
        violation) propagates. While tracing, a ``serve.admit`` span with
        the time since ``submit`` as ``queued_ns``."""
        sp = trace.begin("serve.admit")
        queued_ns = 0 if sp is None else \
            int((time.perf_counter() - req.submitted_at) * 1e9)
        try:
            while True:
                try:
                    if self.ex.faults is not None:
                        self.ex.faults.check("serving.request",
                                             key=str(req.rid))
                    self._prefill_slot(slot, req)
                    return
                except (AllocationFault, PagePoolFull) as e:
                    if self._paged:
                        self.kv.free_slot(slot)
                    self._degrade_or_raise(e)
                    drop_traceback(e)
                except ValueError:
                    raise
                except Exception as e:
                    self._fail_slot(slot, e)
                    drop_traceback(e)
                    return
        finally:
            if sp is not None:
                trace.end(sp, rid=req.rid, prompt_tokens=len(req.prompt),
                          queued_ns=queued_ns)

    def _fail_slot(self, slot: int, exc: Exception):
        """Fail one in-flight request: record the error, free its slot and
        its pages, and emit its terminal error event."""
        req = self.slots[slot]
        req.error = str(exc) or type(exc).__name__
        req.done_at = time.perf_counter()
        self.failed.append(req)
        self.slots[slot] = None
        if self._paged:
            self.kv.free_slot(slot)
        self._events.append(TokenEvent(req.rid, -1, len(req.generated),
                                       True, error=req.error))

    def _degrade_or_raise(self, exc: Exception):
        """Step the owning session one rung down the degradation ladder,
        or re-raise without a session or past the last rung."""
        if self._session is None:
            raise exc
        level = self._session.degrade(reason=str(exc))
        if level is None:
            raise exc
        self.degradations.append({"iteration": self.iterations,
                                  "level": level, "reason": str(exc)})

    # ------------------------------------------------------------ retire
    def _retire(self, slot: int):
        req = self.slots[slot]
        req.done_at = time.perf_counter()
        self.completed.append(req)
        self.slots[slot] = None
        if self._paged:
            # unmap the sequence's pages; prefix-cached blocks survive
            # through the cache's own reference
            self.kv.free_slot(slot)

    # ------------------------------------------------------------ decode
    def _decode_iteration(self):
        """One batched decode step for every active slot (batch-wide new
        token count = #active -> the tier table drives the schedule)."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        before = self.ex.stats.streamed_bytes
        moved_before = self.ex.stats.staged_bytes
        replays = self.ex.stats.decode_graph_replays
        sp = trace.begin("serve.decode")
        try:
            if self.spec_k > 0:
                mode = "spec"
                self._decode_spec(active)
            elif self.fused:
                mode = "fused"
                self._decode_fused(active)
            else:
                mode = "per_slot"
                self._decode_per_slot(active)
        finally:
            if sp is not None:
                trace.end(sp, n_active=len(active), mode=mode,
                          tier=self.tier_log[-1], graphed=replays
                          != self.ex.stats.decode_graph_replays)
        self.iter_streamed_bytes.append(self.ex.stats.streamed_bytes - before)
        self.iter_moved_bytes.append(self.ex.stats.staged_bytes
                                     - moved_before)

    def _device_inputs(self, pos_vec, mask):
        """A decode pass's inputs: the (B, 1) last tokens, (B,) positions
        and (B,) active mask. For a card, page-locked host tensors that the
        executor copies without a wait (the caching host allocator hands a
        block out again only once its copy has run)."""
        host = (torch.as_tensor(self.last_tokens), torch.as_tensor(pos_vec),
                torch.as_tensor(mask))
        if self.device.type == "cuda":
            return tuple(t.pin_memory() for t in host)
        return host

    def _decode_fused(self, active: List[int]):
        """Fused multi-slot step: every active slot advances one token in a
        single batched pass; streamed sub-layers are fetched once for the
        whole iteration. The executor replays the pass where it can be
        recorded (``PipelinedExecutor.decode_fused``)."""
        pos_vec = np.zeros((self.max_batch,), np.int32)
        mask = np.zeros((self.max_batch,), bool)
        for i in active:
            pos_vec[i] = self.slots[i].pos
            mask[i] = True
        self.tier_log.append(self.schedule.pick_decode_tier(
            len(active), queue_depth=self.ex.sched_queue_depth,
            slack_s=self.ex.sched_slack_s))
        tokens, pos_t, mask_t = self._device_inputs(pos_vec, mask)
        _, self.kv, nxt = self.ex.decode_fused(
            tokens, self.kv, pos_t, mask_t, n_active=len(active),
            pick=greedy_token)
        nxt = trace.to_host(nxt, "tokens")
        for i in active:
            self._advance_guard(i, int(nxt[i]))

    def _seq_token(self, req: Request, idx: int) -> int:
        """Committed token at sequence index ``idx``: prompt positions
        first, then generated tokens (generated[0] sits at position
        len(prompt), the prefill's token)."""
        T = len(req.prompt)
        if idx < T:
            return int(req.prompt[idx])
        return int(req.generated[idx - T])

    def _decode_spec(self, active: List[int]):
        """One speculative iteration: draft ``k`` greedy tokens per active
        slot on the pinned draft, verify all ``k+1`` positions in ONE
        streamed target pass, commit the longest accepted prefix plus the
        target's bonus token, roll back the rejected KV suffix. Every
        committed token is the target's own argmax over the same context,
        so the output equals plain greedy decode.

        The window is clamped so every active slot's writes stay inside the
        cache (``pos + W <= max_seq``); near the end it falls back to a
        plain fused step."""
        W = min(self.spec_k + 1,
                self.max_seq - max(self.slots[i].pos for i in active))
        if W < 2:
            self._decode_fused(active)
            return
        k = W - 1
        B = self.max_batch
        pos_vec = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        prev_tok = np.zeros((B,), np.int32)
        for i in active:
            r = self.slots[i]
            pos_vec[i] = r.pos
            mask[i] = True
            prev_tok[i] = self._seq_token(r, r.pos - 1)
        last = self.last_tokens.reshape(-1)
        drafts = self.spec.draft(prev_tok, last, pos_vec, mask, k,
                                 n_active=len(active))
        tokens = np.concatenate([last[:, None], drafts],
                                axis=1).astype(np.int32)
        # a verify pass is a batch-wide new-token count of n_active * W
        self.tier_log.append(self.schedule.pick_decode_tier(
            len(active) * W, queue_depth=self.ex.sched_queue_depth,
            slack_s=self.ex.sched_slack_s))
        dev = self.device
        logits, self.kv = self.ex._run_verify(
            torch.as_tensor(tokens).to(dev), self.kv,
            torch.as_tensor(pos_vec).to(dev), torch.as_tensor(mask).to(dev),
            n_active=len(active))
        targets = trace.to_host(greedy_token(logits), "tokens")   # (B, W)
        keep_pos = np.zeros((B,), np.int32)
        roll_mask = np.zeros((B,), bool)
        st = self.ex.stats
        for i in active:
            r = self.slots[i]
            # longest accepted draft prefix: d_{j+1} == the target's
            # greedy continuation t_j over the same committed context
            a = 0
            while a < k and drafts[i, a] == targets[i, a]:
                a += 1
            e = min(a + 1, r.max_new_tokens - len(r.generated))
            st.spec_drafted += k
            st.spec_accepted += e - 1      # the bonus token is not counted
            for j in range(e):
                if self.slots[i] is None:
                    # failed mid-commit: the rest dies with the request
                    break
                self._advance_guard(i, int(targets[i, j]))
            if e < W:
                st.spec_rollbacks += 1
                st.spec_rolled_back_tokens += W - e
                # a retired slot needs no rollback: a paged free_slot
                # already released its blocks, and a stacked slot's stale
                # tail is masked until the next admission overwrites it
                if self.slots[i] is not None:
                    keep_pos[i] = pos_vec[i] + e
                    roll_mask[i] = True
        if roll_mask.any():
            self.kv = self.ex.rollback_kv(self.kv, keep_pos, roll_mask)

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
            self.tier_log.append(self.schedule.pick_decode_tier(
                1, queue_depth=self.ex.sched_queue_depth,
                slack_s=self.ex.sched_slack_s))
            tokens, pos_t, mask_t = self._device_inputs(pos_vec, mask)
            logits, self.kv = self.ex._run_decode(tokens, self.kv, pos_t,
                                                  mask_t, n_active=1)
            self._advance_guard(i, int(trace.to_host(
                greedy_token(logits[i, -1]), "tokens")))

    def _advance_guard(self, slot: int, token: int):
        """Commit one slot's token under per-request isolation: an error
        servicing it (an injected ``serving.request`` fault keyed to its
        rid) fails that request alone, after the batched pass ran, so the
        other slots commit theirs. Allocation failures belong to the
        ladder in ``step`` and re-raise."""
        try:
            if self.ex.faults is not None:
                self.ex.faults.check("serving.request",
                                     key=str(self.slots[slot].rid))
            self._advance(slot, token)
        except (AllocationFault, PagePoolFull):
            raise
        except Exception as e:
            self._fail_slot(slot, e)
            drop_traceback(e)

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
        sp = trace.begin("serve.step")
        queued = len(self.pending)
        try:
            if self._queue_aware:
                self._apply_queue_hints(admitting=True)
            self._admit(self.pending)
            if self._queue_aware:
                self._apply_queue_hints(admitting=False)
            while True:
                try:
                    self._decode_iteration()
                    break
                except (AllocationFault, PagePoolFull) as e:
                    # degrade one rung and re-run the iteration: the failed
                    # attempt aborted at its pass entry, before any KV
                    # write, and the re-run writes the same tokens at the
                    # same places
                    self._degrade_or_raise(e)
                    drop_traceback(e)
        finally:
            if sp is not None:
                trace.end(sp, admitted=queued - len(self.pending),
                          n_active=sum(1 for r in self.slots
                                       if r is not None))
        self.iterations += 1
        if self._session is not None and self.ex.stats.degraded_sync:
            # the worker watchdog parked the executor on the sync path:
            # the session records the terminal rung
            self._session.note_executor_degraded()
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
                if self._paged:
                    self.kv.free_slot(slot)
                self.cancelled.append(r)
                return "active"
        return None

    def set_queue_pressure(self, depth: int = 0,
                           slack_s: Optional[float] = None):
        """Feed live queue depth and deadline slack into the tier picks and
        turn queue-aware picks on for later steps. ``depth`` is the
        caller's queue beyond ``pending`` (the gateway broker's waiting
        line), ``slack_s`` the tightest deadline slack of its live
        requests. Never calling this keeps every pick queue-blind."""
        self._queue_aware = True
        self._queue_depth = max(0, depth)
        self._slack_s = slack_s

    def _apply_queue_hints(self, admitting: bool):
        """The executor's hint fields at the step's two tier picks: before
        admissions the imminent batch beyond one admission (the prefill
        floor), before the decode pass the rows it holds beyond the active
        ones. The raw depth is capped at what can join the batch."""
        active = sum(1 for s in self.slots if s is not None)
        imminent = min(active + len(self.pending) + self._queue_depth,
                       self.max_batch)
        self.ex.sched_queue_depth = max(0, imminent - (1 if admitting
                                                       else active))
        self.ex.sched_slack_s = self._slack_s

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
        out = {
            "iterations": self.iterations,
            "kv_layout": self.ex.kv_layout,
            "tiers_used": sorted(set(self.tier_log)),
            "streamed_bytes": self.ex.stats.streamed_bytes,
            "streamed_bytes_by_dtype":
                dict(self.ex.stats.streamed_bytes_by_dtype),
            "engine_calls": dict(self.ex.stats.engine_calls),
            "completed": len(done),
            "cancelled": len(self.cancelled),
            # fault handling: requests failed alone, ladder rungs taken
            "failed": len(self.failed),
            "degradations": len(self.degradations),
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
            # speculative decoding: always present, all zeros while
            # speculation is off
            "spec_k": self.spec_k,
            "spec_drafted": self.ex.stats.spec_drafted,
            "spec_accepted": self.ex.stats.spec_accepted,
            "accept_rate": self.ex.stats.accept_rate,
            "spec_rollbacks": self.ex.stats.spec_rollbacks,
            "spec_rolled_back_tokens":
                self.ex.stats.spec_rolled_back_tokens,
            "spec_verify_passes": self.ex.stats.spec_verify_passes,
        }
        if self.spec is not None:
            out["draft"] = self.spec.stats_dict()
        if self._paged:
            # pool residency, fault / eviction traffic and prefix hits
            out["paged_kv"] = self.kv.stats_dict()
            out["page_faults"] = self.ex.stats.page_faults
            out["demanded_page_bytes"] = self.ex.stats.demanded_page_bytes
        return out
