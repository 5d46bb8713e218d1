"""The one traffic generator: a closed loop of clients, driven by a mix's
parameters.

Every seed gets the same sizes. Lengths come in blocks of ``block``
requests; a block holds the ``block`` stratified quantiles of the prompt
and output length distributions, paired by a fixed permutation, and the
seed only shuffles the order within each block and draws the token ids.
So any run completes requests of the same mix of sizes, and two seeds
differ in order and content, not in the work they ask for.
"""
from __future__ import annotations

import math

import numpy as np


def _quantiles(dist: dict, n: int):
    """The ``n`` mid-quantiles of a length distribution, as ints."""
    lo, hi = int(dist["min"]), int(dist["max"])
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "log_uniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return [int(round(x)) for x in v]
    if kind == "uniform":
        return [lo + int(x) for x in np.floor(u * (hi - lo + 1))]
    raise ValueError(f"unknown length distribution {kind!r}")


def block_sizes(mix: dict):
    """The (prompt length, output length) pairs of one block, in the
    fixed pairing every seed shares."""
    n = int(mix.get("block", 16))
    prompts = _quantiles(mix["prompt_len"], n)
    outputs = _quantiles(mix["output_len"], n)
    pairing = np.random.Generator(np.random.PCG64(20_240_601)).permutation(n)
    return [(prompts[i], outputs[int(pairing[i])]) for i in range(n)]


class ClosedLoop:
    """Requests in the order the clients send them: each call of ``next``
    is the next request any client sends. ``seed`` may be any int."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"unsupported loop {mix.get('loop')!r}")
        self.mix = mix
        self.vocab = int(vocab)
        self.clients = int(mix["clients"])
        self.rng = np.random.Generator(np.random.PCG64(abs(int(seed))))
        self._block = block_sizes(mix)
        self._queue = []
        self.sent = 0

    def _refill(self):
        order = self.rng.permutation(len(self._block))
        self._queue.extend(self._block[int(i)] for i in order)

    def next(self):
        """(request id, prompt ids (int32), new tokens)."""
        if not self._queue:
            self._refill()
        t, n = self._queue.pop(0)
        prompt = self.rng.integers(0, self.vocab, size=t, dtype=np.int64)
        rid = self.sent
        self.sent += 1
        return rid, prompt.astype(np.int32), n

    def longest(self) -> int:
        """The most prompt plus new tokens a request of the mix holds."""
        return max(t + n for t, n in self._block)


def warmup_requests(mix: dict, vocab: int):
    """The warm-up's requests: the mix's listed prompt lengths with a few
    new tokens each, ids from a fixed seed (the same work in every run)."""
    w = mix["warmup"]
    rng = np.random.Generator(np.random.PCG64(7))
    return [(-1 - i, rng.integers(0, vocab, size=int(t), dtype=np.int64)
             .astype(np.int32), int(w["output_len"]))
            for i, t in enumerate(w["prompt_len"])]
