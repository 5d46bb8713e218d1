"""Nemotron-H on the port's serving path (``Session.open`` ->
``ContinuousBatcher`` -> ``PipelinedExecutor``), on the CPU at a tiny
size (pattern ``M-M*-M-``, two groups of B and C, state 16, a conv bias,
relu^2), in f32: prefill and decode at three budgets and in both prefill
orders against the benchmark's plain reference (``portbench/reference/
nemotron_h.py``); the same tokens at every budget; a request in a
reused slot equal to the same request in a fresh batcher; a padded
prefill tail leaving a layer's state as the unpadded prompt does; three
planted faults caught; the spans, counters and K1 calls of the Mamba-2
sub-layers; what ``Session.open`` refuses; and every existing
configuration's graph, plan and parameter count unchanged.
"""
import hashlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spec
from portbench.test_portbench_nemotron_h import TINY_NEMOTRON_H
from portbench.weights import draw_weights
from repro_torch import Session
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import (CLI2, InferenceSetting, TimingEstimator,
                              build_graph, build_schedule, run_install,
                              serving, total_weight_bytes, trace)
from repro_torch.core import engine as eng
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.serving import Request
from repro_torch.models import ssm

torch.set_num_threads(1)

MAX_SEQ, MAX_BATCH = 64, 2
BUDGETS = (0.25, 0.5, 2.0)
MODES = ("layer_major", "chunk_major")
# the served logits against the f32 reference: the served path keeps the
# attention layer's KV in bf16 (as every model of the port does), which
# rounds k and v by up to 2^-8 of their size; twice that share of the
# largest logit bounds what it moves a logit by (the served runs read
# 0.0053 of a largest logit of 3.7). A planted fault moves logits by their
# own size.
TOLERANCE = 2 ** -7


@pytest.fixture(scope="module")
def model():
    c = dict(TINY_NEMOTRON_H, torch_dtype="float32")
    arch = spec.architecture(c)
    s = arch.shapes(c, "tiny-nemotron-h")
    cfg = arch.port_config(c, s)
    host = draw_weights(arch.leaves(s), 2 ** 33 + 5, "cpu")
    return {"s": s, "cfg": cfg, "host": host,
            "ref": arch.Reference(s, host, "cpu"),
            "db": run_install(CLI2, quick=True),
            "total": total_weight_bytes(build_graph(cfg))}


def _requests(vocab, lengths=(5, 14, 23, 32), new=6, rid0=0):
    rng = np.random.RandomState(0)
    return [Request(rid=rid0 + i, prompt=rng.randint(0, vocab, size=n)
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]


def _session(model, frac, mode="layer_major", **kw):
    return Session.open(model["cfg"], CLI2, int(model["total"] * frac),
                        InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ),
                        db=model["db"], params=model["host"],
                        max_seq=MAX_SEQ, device="cpu", prefill_mode=mode,
                        **kw)


def serve(model, frac, mode, reqs, monkeypatch, max_batch=MAX_BATCH):
    """Serve ``reqs``; returns (session, {rid: the logits row that chose
    each of its tokens, (n, V)})."""
    sess = _session(model, frac, mode)
    b = sess.batcher(max_batch=max_batch)
    picked, rows = [], {r.rid: [] for r in reqs}
    real = serving.greedy_token
    monkeypatch.setattr(serving, "greedy_token",
                        lambda z: (picked.append(z.detach().clone()),
                                   real(z))[1])
    advance, prefill = b._advance, b._prefill_slot

    def on_token(slot, token):
        rows[b.slots[slot].rid].append(picked[-1][slot])
        advance(slot, token)

    def on_prefill(slot, req):
        n = len(picked)
        prefill(slot, req)
        rows[req.rid].insert(0, picked[n])
    b._advance, b._prefill_slot = on_token, on_prefill
    b.serve(reqs)
    monkeypatch.setattr(serving, "greedy_token", real)
    return sess, {rid: torch.stack(v) for rid, v in rows.items()}


def gap_to_reference(model, reqs, rows):
    """The largest |served - reference| logit over every served token, as
    a share of the largest reference logit."""
    worst, scale = 0.0, 0.0
    for r in reqs:
        T = len(r.prompt)
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                   np.int64)])
        z = model["ref"].logits([seq], [np.arange(T - 1, T - 1 +
                                                  len(r.generated))])[0]
        worst = max(worst, float((rows[r.rid] - z).abs().max()))
        scale = max(scale, float(z.abs().max()))
    return worst / scale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frac", BUDGETS)
def test_served_logits_match_the_reference(model, frac, mode, monkeypatch):
    reqs = _requests(model["s"].vocab)
    sess, rows = serve(model, frac, mode, reqs, monkeypatch)
    assert gap_to_reference(model, reqs, rows) < TOLERANCE
    st = sess.executor.stats
    # four admissions into two slots: every slot reused once
    assert st.state_resets == 4
    if frac < 1:
        assert st.streamed_bytes > 0
    else:
        assert st.streamed_bytes == 0


@pytest.mark.parametrize("mode", MODES)
def test_same_tokens_at_every_budget(model, mode, monkeypatch):
    got = []
    for frac in BUDGETS:
        reqs = _requests(model["s"].vocab)
        serve(model, frac, mode, reqs, monkeypatch)
        got.append([r.generated for r in reqs])
    assert got[0] == got[1] == got[2]


def reused_and_fresh(model, monkeypatch):
    """The last of three requests served where two others ran before it
    in its slot, and the same request served alone."""
    reqs = _requests(model["s"].vocab, lengths=(23, 9, 14), new=5)
    _, rows = serve(model, 0.5, "layer_major", reqs, monkeypatch)
    alone = _requests(model["s"].vocab, lengths=(23, 9, 14), new=5)[2:]
    _, fresh = serve(model, 0.5, "layer_major", alone, monkeypatch)
    return rows[2], fresh[2]


def test_a_reused_slot_serves_as_a_fresh_one(model, monkeypatch):
    reused, fresh = reused_and_fresh(model, monkeypatch)
    assert torch.equal(reused, fresh)


def _layer(model, T, pad, padded):
    """One Mamba-2 layer's step over T tokens from a state that earlier
    tokens left, ``padded`` by ``pad`` more or not; returns (out, conv,
    ssm)."""
    from repro_torch.models.hybrid import pattern_layers
    cfg = model["cfg"]
    w = pattern_layers(model["host"]["layers"], cfg.layer_pattern)[2]
    g = torch.Generator().manual_seed(T)
    x = torch.randn((1, T + pad, cfg.d_model), generator=g)
    conv = torch.randn((1, cfg.ssm_conv - 1,
                        cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
                       generator=g)
    state = torch.randn((1, cfg.n_ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), generator=g)
    if padded:
        out = eng.mamba_step(cfg, w, x, conv, state, valid_len=T)
    else:
        out = eng.mamba_step(cfg, w, x[:, :T], conv, state)
    return out[:, :T], conv, state


@pytest.mark.parametrize("T,pad", [(1, 15), (5, 3), (13, 51), (300, 212)])
def test_a_padded_tail_leaves_the_state_as_unpadded(model, T, pad):
    """A chunk of T valid tokens padded to T + pad (a prompt whose length
    is not a multiple of the chunk) against the same T tokens alone: the
    conv history, the SSM state and the outputs agree to f32 rounding
    (the projections and the scan's sums run over other lengths). At
    T = 300 the unpadded side is longer than one SSD chunk and no
    multiple of it (a chunk-major tail at a 512 tier), which the scan
    fills with zero steps."""
    a, conv_a, ssm_a = _layer(model, T, pad, padded=True)
    b, conv_b, ssm_b = _layer(model, T, pad, padded=False)
    torch.testing.assert_close(conv_a, conv_b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssm_a, ssm_b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


FAULTS = ("no_reset", "padded_tail_in_state", "one_group")


def _plant(fault, monkeypatch):
    if fault == "no_reset":
        monkeypatch.setattr(PipelinedExecutor, "reset_state",
                            lambda self, kv, slot: None)
    elif fault == "padded_tail_in_state":
        real = eng.mamba_step
        monkeypatch.setattr(
            eng, "mamba_step",
            lambda cfg, w, x, conv, st, valid_len=None, active=None:
            real(cfg, w, x, conv, st, None, active))
    else:
        monkeypatch.setattr(
            ssm, "group_heads",
            lambda bc, h: bc[:, :, :1].expand(-1, -1, h, -1))


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_caught(model, fault, monkeypatch):
    """Each fault fails the check that guards it: the reused slot against
    a fresh one, the padded tail's state against the unpadded one, and
    the served logits against the reference."""
    _plant(fault, monkeypatch)
    if fault == "no_reset":
        reused, fresh = reused_and_fresh(model, monkeypatch)
        assert float((reused - fresh).abs().max()) > \
            TOLERANCE * float(fresh.abs().max())
        return
    if fault == "padded_tail_in_state":
        _, _, ssm_a = _layer(model, 5, 3, padded=True)
        _, _, ssm_b = _layer(model, 5, 3, padded=False)
        assert not torch.allclose(ssm_a, ssm_b, rtol=1e-5, atol=1e-6)
    reqs = _requests(model["s"].vocab)
    _, rows = serve(model, 0.5, "layer_major", reqs, monkeypatch)
    assert gap_to_reference(model, reqs, rows) > TOLERANCE


def test_mamba_spans_counters_and_k1_calls(model, monkeypatch):
    """``sub.mamba`` spans, one a Mamba-2 layer, under every decode pass
    and admission; ``state_resets`` one an admission; the state's bytes;
    both Mamba-2 projections of every pass through K1."""
    import repro_torch.kernels.streamed_matmul as smm
    cfg = model["cfg"]
    calls = []
    real = smm._k1
    monkeypatch.setattr(smm, "_k1", lambda x, w: (
        calls.append((x.shape[1], w.shape[-1])), real(x, w))[1])
    sess = _session(model, 0.5)
    reqs = _requests(model["s"].vocab, lengths=(7, 19, 11))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        sess.serve(reqs, max_batch=MAX_BATCH)
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    mamba = [s for s in spans if s.name == "sub.mamba"]
    outer = {}
    for s in mamba:
        p = by_id[s.parent]
        assert p.name in ("serve.decode", "serve.admit")
        outer.setdefault(p.id, []).append(s.attrs["layer"])
        assert s.attrs["source"] in ("pinned", "streamed", "at_use")
    layers = [i for i, k in enumerate(cfg.layer_pattern) if k == "M"]
    passes = [s for s in spans if s.name in ("serve.decode", "serve.admit")]
    assert len(outer) == len(passes) > 0
    assert all(v == layers for v in outer.values())
    kinds = {s.name for s in spans if s.name.startswith("sub.")}
    assert kinds == {"sub.mamba", "sub.ffn", "sub.attn"}
    st = sess.executor.stats
    assert st.state_resets == len(reqs)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert st.ssm_state_bytes == 3 * MAX_BATCH * (
        (cfg.ssm_conv - 1) * conv_ch * 4
        + cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4)
    # one call a Mamba-2 layer a decode pass or prefill chunk
    steps = sum(1 for s in passes if s.name == "serve.decode") \
        + sum(p["chunks"] for p in st.prefill_stats)
    d, di = cfg.d_model, cfg.d_inner
    assert calls.count((d, di + conv_ch + cfg.n_ssm_heads)) == 3 * steps
    # w_out (di = 128 -> 64) and, as wide, the three MLPs' w_down
    assert cfg.d_ff == di and calls.count((di, d)) == 6 * steps


@pytest.mark.parametrize("kw,match", [
    ({"kv_layout": "paged"}, "no pages"),
    ({"spec_k": 2, "draft_cfg": "self"}, "speculative"),
    ({"weight_quant": "int8"}, "int8 or int4"),
])
def test_open_refuses_what_a_hybrid_does_not_serve(model, kw, match):
    cfg = model["cfg"]
    if "weight_quant" in kw:
        cfg = cfg.replace(weight_quant=kw.pop("weight_quant"))
    if kw.get("draft_cfg") == "self":
        kw["draft_cfg"] = cfg
    with pytest.raises(ValueError, match=match):
        Session.open(cfg, CLI2, model["total"],
                     InferenceSetting(batch=2, context=MAX_SEQ),
                     db=model["db"], max_seq=MAX_SEQ, device="cpu", **kw)


def test_the_full_models_parameters():
    """All 98 published layers: 46,791,554,816 parameters by the
    published count, less each Mamba-2 layer's dt_bias (256) and gated
    norm (16,384), which ``_mamba_params`` leaves out, as zamba2's count
    always has."""
    c = dict(TINY_NEMOTRON_H, **json.loads(
        (spec.HERE / "configs" / "nemotron-h-47b-19of98.json").read_text()))
    full = c["reduced"]["hybrid_override_pattern"]["published"]
    c.update(hybrid_override_pattern=full, num_hidden_layers=98)
    arch = spec.architecture(c)
    cfg = arch.port_config(c, arch.shapes(c))
    assert full.count("M") == 45
    assert cfg.param_count() == 46_791_554_816 - 45 * (256 + 16_384)


# ------------------------------------------------- the other configurations
def _digest(rows) -> str:
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def _graph_rows(subs):
    return [[s.name, s.kind, s.layer, s.weight_bytes, s.kv_bytes_per_token,
             sorted((k, repr(v)) for k, v in s.meta.items())] for s in subs]


def _plan_rows(sched):
    return [[t, e.plan.name, repr(e.est_time), e.scratch_bytes, e.act_bytes,
             [[p.sub.name, p.residency, p.engine, p.streamed]
              for p in e.plan.placements]]
            for t, e in sorted(sched.tiers.items())] \
        + [sched.pinned_bytes, sched.kv_pool_bytes]


# each configuration's digest of: its full and smoke graphs (the smoke MoE
# graphs expert-granular), its full and smoke parameter counts, and the
# smoke graph's plan at half its weights for a batch of 2 at 64 positions,
# read before patterned hybrids came to the graph and the planner
UNCHANGED = {
    "yi-9b": "c741d3fafd13b925",
    "qwen3-14b": "2b33dbb614f83cda",
    "qwen3-32b": "7dc3191280ab24df",
    "qwen2-0.5b": "25365a049b1a171d",
    "qwen2-vl-7b": "cd3762cda7fab4a6",
    "musicgen-medium": "4647e677871db452",
    "qwen3-moe-235b-a22b": "48f7cb427ce3e0a5",
    "kimi-k2-1t-a32b": "a5271804d5bdab5d",
    "zamba2-7b": "e9e060e83a916886",
    "xlstm-125m": "e3feb69f4c5d7e3d",
    "nemo8b": "260bbffee3536f06",
    "qwen30b-a3b": "351f4e14fa7ecb33",
}


@pytest.mark.parametrize("arch", list_archs(include_paper=True))
def test_existing_graphs_plans_and_counts_are_unchanged(arch):
    db = run_install(CLI2, quick=True)
    est = TimingEstimator(db, CLI2)
    rows = []
    for kind, cfg in (("full", get_config(arch)),
                      ("smoke", get_smoke_config(arch))):
        g = build_graph(cfg, expert_granular=cfg.moe is not None
                        and kind == "smoke")
        rows += [_graph_rows(g), cfg.param_count()]
        if kind == "smoke":
            rows.append(_plan_rows(build_schedule(
                int(total_weight_bytes(g) * 0.5), g, est,
                InferenceSetting(batch=2, context=64))))
    assert _digest(rows) == UNCHANGED[arch]
