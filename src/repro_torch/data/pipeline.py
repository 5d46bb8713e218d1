"""Deterministic synthetic data pipeline, numpy only: the reference's
``data/pipeline.py`` without JAX.

A learnable Markov-ish token stream (a fixed random transition table per
seed) so a model's loss visibly falls within a few steps, with no external
dataset. Each process materialises only its slice of the global batch;
``process_index`` / ``process_count`` default to 0 / 1 (one card: the
reference reads ``jax.process_index()`` / ``jax.process_count()``).
Batches are byte-equal to the reference's for every seed and step.
"""
from __future__ import annotations

import numpy as np


class DataPipeline:
    def __init__(self, cfg, seq_len: int, global_batch: int, seed: int = 0,
                 process_index=None, process_count=None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.pi = 0 if process_index is None else process_index
        self.pc = 1 if process_count is None else process_count
        assert global_batch % self.pc == 0
        self.local_batch = global_batch // self.pc
        rng = np.random.RandomState(seed)
        self.vocab_eff = min(cfg.vocab, 512)
        # sparse transition table: each token has a handful of likely
        # successors
        self.next_tok = rng.randint(0, self.vocab_eff,
                                    size=(self.vocab_eff, 4))
        self._step = 0

    def _gen_sequence(self, rng, length):
        toks = np.empty(length + 1, np.int32)
        toks[0] = rng.randint(self.vocab_eff)
        choices = rng.randint(0, 4, size=length)
        noise = rng.random(length) < 0.05
        rand = rng.randint(0, self.vocab_eff, size=length)
        for t in range(length):
            toks[t + 1] = rand[t] if noise[t] else \
                self.next_tok[toks[t], choices[t]]
        return toks

    def next_batch(self):
        """Returns the local slice of the next global batch (numpy)."""
        step = self._step
        self._step += 1
        return self.batch_at(step)

    def batch_at(self, step: int):
        """Deterministic access by step (restart / replay)."""
        cfg = self.cfg
        B, T = self.local_batch, self.seq_len
        out_tok = np.empty((B, T), np.int32)
        out_lab = np.empty((B, T), np.int32)
        for b in range(B):
            gidx = step * self.global_batch + self.pi * B + b
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + gidx) % (2**31))
            seq = self._gen_sequence(rng, T)
            out_tok[b], out_lab[b] = seq[:-1], seq[1:]
        if cfg.n_codebooks:
            q = cfg.n_codebooks
            tok = np.stack([(out_tok + i * 7) % min(cfg.vocab, self.vocab_eff)
                            for i in range(q)], axis=-1)
            lab = np.stack([(out_lab + i * 7) % min(cfg.vocab, self.vocab_eff)
                            for i in range(q)], axis=-1)
            return {"tokens": tok, "labels": lab}
        return {"tokens": out_tok, "labels": out_lab}


def make_batch(cfg, seq_len, batch, seed=0):
    """One-shot batch for tests and examples."""
    return DataPipeline(cfg, seq_len, batch, seed,
                        process_index=0, process_count=1).batch_at(0)
