"""The port's counted FLOPs and its probe (``launch/dryrun.py``,
``launch/probe.py``), on the CPU.

- the probe: the extrapolation from two depths equals the full-depth
  count where the layers repeat (the flops of every step, the bytes of
  prefill and decode; a train step's bytes exceed it by exactly the
  stacked gradients' quadratic term, see ``test_probe_extrapolation``);
- the dense smoke cells' flops equal a hand count written here from the
  config's shapes;
- the published dense, vlm and audio configs' flops lie within a band of
  the reference's analytic ``model_flops_per_chip`` (``dryrun.model_flops``,
  held equal to it in ``test_torch_dryrun_ref.py``), a band derived from
  what the analytic count leaves out (``test_flops_within_band_of_model``).

Counts are integers and are compared exactly.
"""
import pytest
import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import counting, dryrun, probe

torch.set_num_threads(1)

KINDS = ("train", "prefill", "decode")


# smoke configs whose layers repeat: whole hybrid groups, whole xLSTM pairs
PROBE_CFGS = {"qwen2-0.5b": 4, "zamba2-7b": 9, "xlstm-125m": 6}
PROBE_SHAPES = {"train": (2, 16), "prefill": (2, 16), "decode": (2, 16)}


def _probe_case(arch, kind, depths, monkeypatch):
    """The probe's record and the counts at ``depths`` (the probe reads
    its two depths' counts from them rather than count them again)."""
    cfg = get_smoke_config(arch).replace(n_layers=PROBE_CFGS[arch])
    B, S = PROBE_SHAPES[kind]
    shape = ShapeConfig("t", kind, S, B)
    counts = {d: dryrun.count_cell(arch, shape, "cpu", n_layers=d,
                                   cfg=cfg)[0] for d in sorted(set(depths))}
    monkeypatch.setattr(probe, "_cost_at_depth", lambda a, s, d, dev, c: {
        "flops": counts[d].flops, "bytes": counts[d].bytes_accessed,
        "coll": 0})
    out = probe.probe_cell(arch, shape, save=False, device="cpu", cfg=cfg)
    return out, counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(PROBE_CFGS))
def test_probe_extrapolation(arch, kind, monkeypatch):
    """Eager code has no scan: where the layers repeat, two depths give
    the full-depth flops exactly, and the bytes of prefill and decode.
    A train step's bytes grow with the square of the depth by the
    stacked-param gradients: autograd takes layer i's weights as a slice
    of each (n_layers, ...) leaf, and the slice's backward writes a
    gradient of the whole stack that is then accumulated, so the bytes'
    second difference is a constant D, and the full count is the probe's
    plus D (n - d1)(n - d2) / (2 (d2 - d1)^2) in units of the depth
    pair."""
    cfg0 = get_smoke_config(arch)
    d1, d2, _ = probe.depth_pair(cfg0)
    n = PROBE_CFGS[arch]
    depths = (d1, d2, 2 * d2 - d1, n) if kind == "train" else (d1, d2, n)
    out, counts = _probe_case(arch, kind, depths, monkeypatch)
    full = counts[n]
    assert out["depths"] == [d1, d2] and out["flops"] == full.flops
    assert out["coll"] == 0
    if kind != "train":
        assert out["bytes"] == full.bytes_accessed
        return
    step = d2 - d1
    b1, b2 = counts[d1].bytes_accessed, counts[d2].bytes_accessed
    b3 = counts[2 * d2 - d1].bytes_accessed         # d1 + 2 steps
    D = b3 - 2 * b2 + b1
    assert D > 0
    u = (n - d1) // step                            # units past d1
    assert full.bytes_accessed == out["bytes"] + D * u * (u - 1) // 2


# ------------------------------------------------------------ hand count
def _dense_flops(cfg, kind, B, T, S):
    """The products of a dense decoder's step, from its shapes. Per layer
    and token, the projections' 2 P multiply-adds (P = d (H + 2 KV) hd +
    H hd d + 3 d f); per layer the attention's two products over every
    (query, key) pair the step computes, 4 B H T S hd (the reference's
    ``attend_ref`` and ``attend_cached`` mask after the product), or K4's
    4 B H hd x the visible pairs where ``attend`` takes K4 (T > 2048); the
    head's 2 d V a token (an embedding lookup is no product). A backward
    doubles every product (an input's and a weight's gradient); remat
    full recomputes each layer's forward up to the last tensor its
    backward needs (``torch.utils.checkpoint`` stops early), which leaves
    out the down projection, whose output nothing saves; K4's backward is
    ``flash_bwd_work``'s 10 B H hd x the pairs."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    f, V, L = cfg.d_ff, cfg.vocab, cfg.n_layers
    P = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f
    tok = B * T
    head = 2 * d * V * tok
    flash = kind == "train" and T > 2048
    if flash:
        A = 4 * B * H * hd * counting.visible_pairs(T, T, True)
    else:
        A = 4 * B * H * T * S * hd
    layer = 2 * P * tok + A
    if kind != "train":
        return L * layer + head
    bwd_attn = 2.5 * A if flash else 2 * A
    return int(L * (layer + (layer - 2 * d * f * tok) + 2 * 2 * P * tok
                    + bwd_attn) + 3 * head)


@pytest.mark.parametrize("kind,T", [("train", 32), ("train", 2112),
                                    ("prefill", 48), ("decode", 40)])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-9b"])
def test_dense_flops_match_hand_count(arch, kind, T):
    cfg = get_smoke_config(arch)
    B = 2
    rec = dryrun.count_cell(arch, ShapeConfig("t", kind, T, B), "cpu",
                            cfg=cfg)[0]
    if kind == "decode":
        want = _dense_flops(cfg, kind, B, 1, T)
    else:
        want = _dense_flops(cfg, kind, B, T, T)
    assert rec.flops == want
    if T > 2048:
        assert rec.kernels["K4"]["units"] == 2 * cfg.n_layers
        assert rec.kernels["K4bwd"]["units"] == cfg.n_layers


# the band of counted / analytic flops for each kind, for a decoder whose
# every layer attends (dense, vlm, audio). The analytic count is 2 (6 for
# train) x active params x tokens plus the attention's products over T^2/2
# pairs (x3 for train). What it leaves out or adds:
# - below: it counts the embedding lookup and the norms and biases as
#   products (2 x their params a token, x3 for train); the lookup is at
#   most 8% of the active params of these configs, so the floor is 0.92;
# - decode: attention over all S cached keys, 4 S H hd a token, as the
#   analytic count's, so the ceiling is 1;
# - prefill: the cached prefill (``attend_cached``) computes every (query,
#   key) pair, T S, twice the analytic T^2/2 (S = T): the ceiling is 2;
# - train with remat full: the recompute adds at most a third to the
#   layers' products (2 of 6), and K4's forward twice and backward (2.5
#   forwards) are 4.5 forwards of the exact causal pairs, T (T + 1) / 2,
#   against the analytic 3 x T^2 / 2: at most 1.5 (T + 1) / T.
BAND = {"decode": (0.92, 1.0), "prefill": (0.92, 2.0),
        "train": (0.92, 1.5 * 4097 / 4096)}
BAND_ARCHS = ("yi-9b", "qwen2-0.5b", "qwen2-vl-7b", "musicgen-medium")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", BAND_ARCHS)
def test_flops_within_band_of_model(arch, shape):
    """The published config at full depth, its flops from the probe's two
    depths (exact for flops, ``test_probe_extrapolation``). MoE is not
    banded: the port computes every expert's capacity rows, E C against
    the analytic top_k T (E / top_k times more where capacity is
    dropless); nor are the hybrid and xLSTM families: the analytic count
    has no term for their scans' products."""
    cfg = get_config(arch)
    flops = probe.probe_cell(arch, shape, save=False, device="cpu")["flops"]
    ratio = flops / dryrun.model_flops(cfg, SHAPES[shape])
    lo, hi = BAND[SHAPES[shape].kind]
    assert lo <= ratio <= hi, (arch, shape, ratio)
