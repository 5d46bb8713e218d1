"""The traffic generator: the seed decides the requests, and every seed
asks for the same sizes."""
import numpy as np

from portbench.conftest import TINY_MIX
from portbench.spec import HERE
from portbench.traffic import ClosedLoop, block_sizes

import json

NPC4 = json.loads((HERE / "traffic" / "npc4.vram50.json").read_text())
BIG_SEED = 2 ** 31 + 987_654_321


def _take(mix, seed, n, vocab=151936):
    loop = ClosedLoop(mix, vocab, seed)
    return [loop.next() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = _take(NPC4, BIG_SEED, 40), _take(NPC4, BIG_SEED, 40)
    assert [(r, n) for r, _, n in a] == [(r, n) for r, _, n in b]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_other_seed_other_order_same_sizes():
    a, b = _take(NPC4, BIG_SEED, 32), _take(NPC4, BIG_SEED + 1, 32)
    sizes = lambda reqs: sorted((len(p), n) for _, p, n in reqs)  # noqa
    assert sizes(a) == sizes(b) == sorted(block_sizes(NPC4) * 2)
    assert [(len(p), n) for _, p, n in a] != [(len(p), n) for _, p, n in b]
    assert not np.array_equal(a[0][1], b[0][1]) or len(a[0][1]) \
        != len(b[0][1])


def test_sizes_follow_the_mix():
    sizes = block_sizes(NPC4)
    prompts = [t for t, _ in sizes]
    outputs = [n for _, n in sizes]
    assert 256 <= min(prompts) and max(prompts) <= 1024
    assert 16 <= min(outputs) and max(outputs) <= 64
    # log-uniform: the median prompt lies near the geometric mean, 512
    assert 430 <= float(np.median(prompts)) <= 600
    assert max(t + n for t, n in sizes) <= NPC4["max_seq"]
    ids = np.concatenate([p for _, p, _ in _take(NPC4, 3, 16)])
    assert ids.min() >= 0 and ids.max() < 151936 and ids.dtype == np.int32


def test_tiny_mix_runs_past_a_block():
    reqs = _take(TINY_MIX, 5, 3 * TINY_MIX["block"] + 1, vocab=512)
    assert [r for r, _, _ in reqs] == list(range(len(reqs)))
