"""The frozen yardstick against the port's own counts
(``launch/counting.py``) at the four cells' shapes."""
import dataclasses
import json

import pytest

from portbench import spec
from portbench.roofline import peaks, work
from portbench.spec import HERE


def _shapes(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return spec.architecture(cfg).shapes(cfg, name)


CONFIGS = {n: _shapes(n)
           for n in ("qwen3-14b-10of40", "qwen3-30b-a3b-12of48")}


def k1_shapes(s, M):
    """K1's (M, K, N) calls of one decode pass at M rows."""
    if s.moe:
        return [(M, s.d, s.n_experts), (M, s.d, s.d_ff), (M, s.d_ff, s.d)]
    return [(M, s.d, s.d_ff), (M, s.d_ff, s.d)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("M", [1, 4, 64, 1024])
def test_k1_counts_match_the_port(name, M):
    from repro_torch.launch import counting
    for m, k, n in k1_shapes(CONFIGS[name], M):
        for dtype, b in (("bfloat16", 2), ("float32", 4)):
            assert work.k1_work(m, k, n, b) == \
                counting.matmul_work(m, k, n, b)
            ms, _ = counting.bound_ms(
                counting.matmul_work(m, k, n, b),
                counting.PEAK_BF16_FLOPS if b == 2
                else counting.PEAK_F32_FLOPS)
            assert work.k1_bound_s(m, k, n, dtype) == \
                pytest.approx(ms / 1e3, rel=1e-12)


def test_peaks_match_the_port():
    from repro_torch.launch import counting
    assert peaks.BF16_FLOPS == counting.PEAK_BF16_FLOPS
    assert peaks.F32_FLOPS == counting.PEAK_F32_FLOPS
    assert peaks.HBM_BYTES_S == counting.PEAK_HBM_BPS


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_flops_match_the_count(name):
    """One decode step of B = 4 at cache length S, counted on fake
    tensors by the port's ``count_step`` at one and two layers of full
    width: a layer's products are B analytic tokens that see all S cache
    positions (the step attends over the whole cache, masked), plus, for
    MoE, every expert over its B capacity rows in place of the top-k
    (a count cannot read the routes); the rest is B logits rows."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    s = CONFIGS[name]
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    port_config = spec.architecture(cfg).port_config
    B, S = 4, 1088
    counts = [count_cell(None, ShapeConfig("d", "decode", S, B),
                         device="cpu",
                         cfg=port_config(cfg, s).replace(n_layers=L))[0]
              .flops for L in (1, 2)]
    one = dataclasses.replace(s, n_layers=1)
    layer = B * work.token_flops(one, S)
    if s.moe:
        layer += (s.n_experts - s.top_k) * B * 6 * s.d * s.d_ff
    assert counts[1] - counts[0] == layer
    assert counts[0] - layer == B * work.head_flops(s)


def test_prompt_flops_are_the_sum_of_its_tokens():
    for s in CONFIGS.values():
        T = 300
        assert work.prompt_flops(s, T) == sum(
            work.token_flops(s, p + 1) for p in range(T)) \
            + work.head_flops(s)
