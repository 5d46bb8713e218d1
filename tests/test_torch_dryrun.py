"""The port's per-step counts (``repro_torch.launch.counting``) on the
CPU: the kernel wrappers' hand counts and what a count leaves behind.

- hand counts: each kernel wrapper (K1, K2, K3, K4, K4's backward, and
  ``ops.flash_attention_bthd``) counts one unit whose operations and bytes
  are the formulas of ``counting`` (``matmul_work``, ``flash_work``,
  ``flash_bwd_work``), at ragged and causal shapes, with the bf16
  kernel's split-K workspace and K4's backward's D scratch in the peak;
  on CPU tensors inside a count a wrapper counts what its fake call
  counts; ``chip_smoke.py``'s bounds, now taken from ``counting``, are
  the floats PERF.md's bounds were printed from;
- a count leaves nothing behind: the rope and sinusoidal caches hold no
  fake tensor after it and a real forward after it is ``torch.equal`` to
  one before; outside a count every wrapper raises on a fake tensor (and
  on a meta one, as before), and a fake count moves no launch counter;
- the specs claim the card on a machine without one.

Fake against real counts: ``test_torch_dryrun_fake.py``; the probe and
the FLOPs against hand and analytic counts: ``test_torch_dryrun_flops.py``;
against the JAX package: ``test_torch_dryrun_ref.py``. Counts are integers
and are compared exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.device import is_fake
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import streamed_matmul as sm
from repro_torch.launch import counting, dryrun
from repro_torch.models import api, common
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

KINDS = ("train", "prefill", "decode")


def _same(a, b):
    """Two counts' integers, every field but the op count (a fake tensor
    answers some queries, such as its device, through the dispatcher)."""
    da, db = a.as_dict(), b.as_dict()
    for d in (da, db):
        d.pop("fake")
        d.pop("n_ops")
    return da, db


def _fake_like(args):
    """Fake tensors (no storage) of ``args``' shapes and dtypes."""
    with api.spec_mode():
        return [torch.empty(a.shape, dtype=a.dtype)
                if isinstance(a, torch.Tensor) else a for a in args]


def _count(fn, args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    with counting.count_step(*tensors) as rec:
        rec.outputs(fn(*args))
    return rec


def _kernel_case(fn, args, unit, work):
    """``fn`` on real CPU tensors and on fake ones counts one ``unit``
    whose (operations, bytes) are ``work``, and both counts agree."""
    real = _count(fn, args)
    fake = _count(fn, _fake_like(args))
    assert real.kernels == {unit: {"units": 1, "flops": work[0],
                                   "bytes": work[1]}}
    assert real.flops == work[0] and real.bytes_accessed == work[1]
    assert not real.fake and fake.fake
    assert _same(real, fake)[0] == _same(real, fake)[1]
    return real


def _rand(shape, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


# ------------------------------------------------------------ hand counts
@pytest.mark.parametrize("M,K,N,dtype", [(3, 37, 129, torch.float32),
                                         (17, 56, 112, torch.bfloat16),
                                         (5, 4096, 64, torch.bfloat16)])
def test_k1_hand_count(M, K, N, dtype):
    x, w = _rand((M, K), dtype), _rand((K, N), dtype, 1)
    es = torch.tensor([], dtype=dtype).element_size()
    rec = _kernel_case(sm.streamed_matmul, [x, w], "K1",
                       counting.matmul_work(M, K, N, es))
    # the peak holds the arguments, the output and, where the bf16
    # kernel splits K, its f32 workspace and per-tile counters
    ws = sm.workspace_shape(M, K, N) if dtype == torch.bfloat16 else None
    temps = 0 if ws is None else (
        4 * ws[0] * ws[1] * ws[2] + 4 * -(-ws[1] // 16) * -(-N // 64))
    assert (ws is not None) == (K == 4096)
    assert rec.peak_live_bytes == (M * K + K * N + M * N) * es + temps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,g", [(700, 96, 117), (56, 112, 128)])
def test_k2_k3_hand_counts(dtype, K, N, g):
    w = _rand((K, N), seed=2)
    # clones: the quantisers' codes are rows of an edge-padded buffer, and
    # the fake copies' storages hold exactly their elements
    q8, s8 = (t.clone() for t in sm.quantize_int8(w, block_k=g))
    q4, s4, z4 = (t.clone() for t in sm.quantize_int4(w, group_size=g))
    x = _rand((17, K), dtype, 3)
    es = x.element_size()
    w8 = q8.numel() + s8.numel() * 4
    w4 = q4.numel() + s4.numel() * 2 + z4.numel()
    _kernel_case(sm.streamed_matmul_int8, [x, q8, s8], "K2",
                 counting.matmul_work(17, K, N, es, w_bytes=w8))
    _kernel_case(sm.streamed_matmul_int4, [x, q4, s4, z4], "K3",
                 counting.matmul_work(17, K, N, es, w_bytes=w4))


# (B, H, KV, Tq, Tk, hd): ragged, Tq != Tk, GQA
FLASH = [(2, 4, 2, 33, 41, 16), (1, 6, 2, 40, 40, 8), (1, 2, 1, 50, 17, 4)]


@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("causal", [True, False])
def test_k4_hand_count(shape, causal):
    B, H, KV, Tq, Tk, hd = shape
    q = _rand((B, H, Tq, hd), torch.bfloat16, 4)
    k, v = _rand((B, KV, Tk, hd), torch.bfloat16, 5), \
        _rand((B, KV, Tk, hd), torch.bfloat16, 6)
    work = counting.flash_work(shape, causal, 2)
    rec = _kernel_case(lambda a, b, c: fa.flash_attention(a, b, c,
                                                          causal=causal),
                       [q, k, v], "K4", work)
    assert rec.output_bytes == B * H * Tq * hd * 2
    # the model's layout: the same unit
    _kernel_case(lambda a, b, c: ops.flash_attention_bthd(a, b, c,
                                                          causal=causal),
                 [t.transpose(1, 2).contiguous() for t in (q, k, v)], "K4",
                 work)


@pytest.mark.parametrize("shape", FLASH[:2])
def test_k4_backward_hand_count(shape):
    """K4 with its gradient: the forward's unit asks for the lse too, the
    backward is one K4bwd unit of ``flash_bwd_work``, and the peak holds
    the backward's f32 D scratch."""
    B, H, KV, Tq, Tk, hd = shape

    def fwd_bwd(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = ops.flash_attention_bthd(q, k, v, causal=True)
            return torch.autograd.grad(o, [q, k, v], torch.ones_like(o))
    args = [_rand((B, Tq, H, hd), torch.bfloat16, 7),
            _rand((B, Tk, KV, hd), torch.bfloat16, 8),
            _rand((B, Tk, KV, hd), torch.bfloat16, 9)]
    real = _count(fwd_bwd, args)
    fake = _count(fwd_bwd, _fake_like(args))
    f_ops, f_bytes = counting.flash_work(shape, True, 2, lse=True)
    b_ops, b_bytes = counting.flash_bwd_work(shape, True, 2)
    assert real.kernels == {
        "K4": {"units": 1, "flops": f_ops, "bytes": f_bytes},
        "K4bwd": {"units": 1, "flops": b_ops, "bytes": b_bytes}}
    assert b_ops == 10 * B * H * hd * counting.visible_pairs(Tq, Tk, True)
    assert _same(real, fake)[0] == _same(real, fake)[1]
    # the backward alone: its peak holds q, k, v, dO, lse, dq, dk, dv and
    # the f32 D scratch
    bwd = [args[0], args[1], args[2], args[0].clone(),
           torch.zeros((B, H, Tq))]
    real = _kernel_case(lambda *a: fa.flash_attention_backward(
        *a, causal=True, bthd=True), bwd, "K4bwd",
        (b_ops, b_bytes))
    qkv = (B * Tq * H + 2 * B * Tk * KV) * hd * 2
    assert real.peak_live_bytes == 2 * qkv + B * Tq * H * hd * 2 \
        + 2 * B * H * Tq * 4


def test_bounds_match_the_printed_formulas():
    """``chip_smoke.py``'s bounds now come from ``counting``: the same
    floats as the formulas PERF.md's bounds were printed from, at its
    headline shapes."""
    def old_mm(M, K, N, db, w_bytes=None):
        w_bytes = K * N * db if w_bytes is None else w_bytes
        t_b = ((M * K + M * N) * db + w_bytes) / 3.35e12 * 1e3
        t_o = 2.0 * M * N * K / 989e12 * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def old_flash(shape, causal, db, bwd=False):
        B, H, KV, Tq, Tk, hd = shape
        pairs = counting.visible_pairs(Tq, Tk, causal)
        if bwd:
            t_o = 2.5 * 4.0 * B * H * hd * pairs / 989e12 * 1e3
            b = (3 * B * H * Tq + 4 * B * KV * Tk) * hd * db + B * H * Tq * 4
        else:
            t_o = 4.0 * B * H * hd * pairs / 989e12 * 1e3
            b = (2 * B * H * Tq + 2 * B * KV * Tk) * hd * db
        t_b = b / 3.35e12 * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    bf = counting.PEAK_BF16_FLOPS
    for M, K, N in ((4, 896, 4864), (16, 5120, 17408), (1, 56, 112)):
        for wb in (None, K * N + -(-K // 128) * N * 4):
            assert counting.bound_ms(counting.matmul_work(M, K, N, 2, wb),
                                     bf) == old_mm(M, K, N, 2, wb)
    for shape, causal in (((1, 16, 16, 4641, 4641, 80), False),
                          ((1, 28, 4, 4096, 4096, 128), True),
                          ((4, 14, 2, 4096, 4096, 64), True),
                          ((1, 28, 4, 2081, 2081, 128), True)):
        assert counting.bound_ms(counting.flash_work(shape, causal, 2),
                                 bf) == old_flash(shape, causal, 2)
        assert counting.bound_ms(counting.flash_bwd_work(shape, causal, 2),
                                 bf) == old_flash(shape, causal, 2, True)


# ------------------------------------------------------- nothing left behind
def _forward(cfg, params, tokens, positions=None):
    batch = {"tokens": tokens}
    if positions is not None:
        batch["positions"] = positions
    return api.build_model(cfg).apply(params, batch)[0]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-medium",
                                  "qwen2-vl-7b"])
def test_count_leaves_no_fake_tensor_behind(arch):
    cfg = get_smoke_config(arch)
    common._FREQS.clear()
    common._SIN_FREQS.clear()
    common._MROPE_AXES.clear()
    params = api.build_model(cfg).init(torch.Generator().manual_seed(0))
    shape = (2, 8, cfg.n_codebooks) if cfg.n_codebooks else (2, 8)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, shape))
    pos = torch.arange(8).expand(3, 2, 8) if cfg.family == "vlm" else None
    before = _forward(cfg, params, tokens, pos)
    for kind in KINDS:
        dryrun.count_cell(arch, ShapeConfig("t", kind, 16, 2), "cpu",
                          cfg=cfg)
    for cache in (common._FREQS, common._SIN_FREQS, common._MROPE_AXES):
        assert not any(is_fake(t) for t in cache.values())
    assert torch.equal(_forward(cfg, params, tokens, pos), before)
    # a cache filled by a real run is read by the next count unchanged
    dryrun.count_cell(arch, ShapeConfig("t", "decode", 16, 2), "cpu",
                      cfg=cfg)
    assert torch.equal(_forward(cfg, params, tokens, pos), before)


def _wrapper_calls(t):
    """Every kernel wrapper on tensors like ``t`` (a (4, 8) matrix)."""
    q8, s8 = sm.quantize_int8(torch.ones(8, 8), block_k=8)
    q4, s4, z4 = sm.quantize_int4(torch.ones(8, 8), group_size=8)
    a = t.reshape(1, 2, 2, 8)
    lse = torch.zeros((1, 2, 2))
    q8, s8, q4, s4, z4, lse = _fake_like([q8, s8, q4, s4, z4, lse]) \
        if is_fake(t) else (q8, s8, q4, s4, z4, lse)
    return {"K1": lambda: sm.streamed_matmul(t, t.T.contiguous()),
            "K2": lambda: sm.streamed_matmul_int8(t, q8, s8),
            "K3": lambda: sm.streamed_matmul_int4(t, q4, s4, z4),
            "K4": lambda: fa.flash_attention(a, a, a),
            "K4 bthd": lambda: ops.flash_attention_bthd(a, a, a),
            "K4bwd": lambda: fa.flash_attention_backward(a, a, a, a, lse,
                                                         causal=True)}


def test_wrappers_raise_on_fake_tensors_outside_a_count():
    (x,) = _fake_like([torch.ones(4, 8)])
    for name, call in _wrapper_calls(x).items():
        with pytest.raises(ValueError, match="fake tensor outside a count"):
            call()
    with pytest.raises(ValueError):    # meta raises, as it always did
        sm.streamed_matmul(torch.empty(4, 8, device="meta"),
                           torch.empty(8, 4, device="meta"))


def test_fake_count_moves_no_launch_counter():
    fns = (sm.streamed_matmul, sm.streamed_matmul_int8,
           sm.streamed_matmul_int4, fa.flash_attention,
           fa.flash_attention_backward)
    before = [(f.launches, dict(f.variant_launches)) for f in fns]
    (x,) = _fake_like([torch.ones(4, 8)])
    calls = _wrapper_calls(x)
    with counting.count_step(x) as rec:
        for call in calls.values():
            call()
    assert sorted(rec.kernels) == ["K1", "K2", "K3", "K4", "K4bwd"]
    assert rec.kernels["K4"]["units"] == 2
    assert [(f.launches, dict(f.variant_launches)) for f in fns] == before


def test_specs_claim_the_card_without_one():
    """``param_specs`` / ``input_specs`` give fake tensors on ``cuda`` by
    default, on a machine without a card."""
    cfg = get_smoke_config("qwen2-vl-7b")
    p = api.param_specs(cfg)
    sp = api.input_specs(cfg, SHAPES["train_4k"])
    for t in tree_leaves(p) + tree_leaves(sp):
        assert t.device.type == "cuda" and is_fake(t)
    assert set(sp["batch"]) == {"tokens", "vision_embeds", "positions",
                                "labels", "loss_mask"}
    assert sp["batch"]["tokens"].shape == (256, 4096 - cfg.n_vision_tokens)
    audio = api.input_specs(get_smoke_config("musicgen-medium"),
                            SHAPES["decode_32k"], device="cpu")
    assert audio["batch"]["tokens"].shape == (128, 1, 4)
    assert audio["pos"].shape == () and audio["pos"].dtype == torch.int32
