"""Speculative decoding: the draft side, wholly pinned on the device.

``SpecDecoder`` owns the draft model's executor and its stacked KV cache.
The draft is planned wholly into VRAM by ``plan_draft_carve`` (every
compute sub-layer pinned, nothing streamed) and runs with ``overlap=False``
so it never starts a ``PrefetchEngine``: the target's scratch and copy
streams are its own, and the draft adds zero streamed bytes to any ledger.

Per speculative iteration the decoder drafts ``k`` greedy tokens for every
active slot:

1. a width-2 catch-up pass (the draft's own ``_run_verify``) feeding
   ``[seq[pos-1] @ pos-1, last @ pos]``: position ``pos-1`` covers the one
   cache entry a full acceptance leaves unwritten (the last drafted token
   was produced but never fed); after a partial acceptance it rewrites an
   already-written position with the same token over the same prefix,
   which is bit-identical. It yields ``d_1``;
2. ``k-1`` fused decode steps, each feeding ``d_i @ pos+i`` to produce
   ``d_{i+1}``.

Rejected draft tokens leave stale entries in the draft cache beyond the
committed position; they are never attended (the decode mask stops at
``pos``) and are overwritten before they could be, so the draft needs no
rollback: the draft moves the acceptance rate, never the emitted tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.models.common import greedy_token


class SpecDecoder:
    """Draft-model runner for speculative serving."""

    def __init__(self, cfg, params, schedule, max_batch: int, max_seq: int,
                 device=None):
        # imported here: the executor imports the planner, and the draft
        # runner is only built once a session turns speculation on
        from repro_torch.core.executor import PipelinedExecutor
        self.cfg = cfg
        self.max_batch = max_batch
        self.ex = PipelinedExecutor(cfg, params, schedule, max_seq=max_seq,
                                    overlap=False, kv_layout="stacked",
                                    device=device)
        self.device = self.ex.device
        self.kv = self.ex.init_kv(max_batch)

    def prefill_slot(self, slot: int, prompt: np.ndarray):
        """Write the prompt into the draft's KV slot (slot-threaded
        layer-major prefill; the draft streams nothing, so this is pinned
        compute only). The draft's own first prediction is dropped: the
        verify window's column 0 is always the target's last token."""
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)[None]
        self.ex.prefill(tokens, kv=self.kv, slot=slot)

    def draft(self, prev_tokens: np.ndarray, last_tokens: np.ndarray,
              pos_vec: np.ndarray, active: np.ndarray, k: int,
              n_active: int) -> np.ndarray:
        """``k`` greedy draft tokens per slot. ``prev_tokens[b]`` is the
        committed token at ``pos_vec[b] - 1`` (prompt or generated),
        ``last_tokens[b]`` the one at ``pos_vec[b]`` whose KV entry does
        not exist yet anywhere. Returns a (B, k) int32 array; rows of
        inactive slots are meaningless and never read."""
        dev = self.device
        catch_up = torch.as_tensor(
            np.stack([prev_tokens, last_tokens], axis=1).astype(np.int32))
        base = torch.as_tensor(np.asarray(pos_vec, np.int32)).to(dev)
        act = torch.as_tensor(np.asarray(active, bool)).to(dev)
        logits, self.kv = self.ex._run_verify(
            catch_up.to(dev), self.kv, base - 1, act, n_active=n_active)
        cur = greedy_token(logits[:, 1:2])
        drafts = [cur[:, 0]]
        for i in range(1, k):
            logits, self.kv = self.ex._run_decode(cur, self.kv, base + i,
                                                  act, n_active=n_active)
            cur = greedy_token(logits[:, -1:])
            drafts.append(cur[:, 0])
        return trace.to_host(torch.stack(drafts, dim=1),
                             "draft").astype(np.int32)

    def stats_dict(self) -> dict:
        """Draft-side counters (every streamed-byte entry stays 0: the
        draft is wholly pinned)."""
        return {
            "streamed_bytes": self.ex.stats.streamed_bytes,
            "decode_passes": self.ex.stats.decode_passes,
            "verify_passes": self.ex.stats.spec_verify_passes,
            "prefill_passes": self.ex.stats.prefill_passes,
        }
