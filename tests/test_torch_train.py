"""The port's training path against the JAX package, on the CPU, at the
smoke configs: the loss, the gradients of every arch, remat, AdamW, the
train step with and without microbatches, the ``segsum`` autograd repair,
K1's gradient, and ``repro_torch.launch.train``.

- ``cross_entropy`` against the reference's, with a ``loss_mask``, the
  audio family's (B, T, nq, V) logits and the VLM's masked vision rows;
- (every arch's gradients and remat: ``tests/test_torch_grads.py``);
- one ``adamw_update`` and ``cosine_lr`` against the reference's; one
  whole train step, microbatches 1 and 4 (MoE 1 and 2), against the
  reference's;
- the SSD's ``segsum`` / ``exp`` in place made the hybrid's backward raise;
  out of place under autograd it runs, and without grad the in-place
  forms keep their bits and allocations;
- K1 through ``StreamedMatmul`` and K2 / K3 refusing a gradient; a
  quantised config's train step raising;
- ``launch.train.main`` on the CPU, a fault and its restart included.

Inputs are made from seeds with numpy; the reference's weights reach the
port through the numpy param bridge.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import build_model as jax_build
from repro.models.api import cross_entropy as jax_ce
from repro.optim import OptConfig as JOpt
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels import streamed_matmul as sm
from repro_torch.kernels.ref import streamed_matmul_ref
from repro_torch.launch import steps, train
from repro_torch.models import build_model as torch_build
from repro_torch.models import ssm
from repro_torch.models.api import (cross_entropy, params_from_numpy,
                                    tensor_from_numpy)
from repro_torch.models.common import tree_flatten
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               cosine_lr)

torch.set_num_threads(1)

B, T = 2, 8
F32_TOL = 1e-5
BF16_TOL = 2e-2


def batch_np(cfg, seed=0, b=B, t=T):
    """A training batch as numpy: tokens and labels; the vlm family's
    vision embeddings in front of ``t`` tokens, their 3D positions and a
    ``loss_mask`` that leaves the vision rows out."""
    rng = np.random.RandomState(seed)
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        S = t + nv
        return {"tokens": rng.randint(0, cfg.vocab, (b, t)).astype(np.int32),
                "vision_embeds": rng.randn(b, nv, cfg.d_model)
                .astype(np.float32),
                "positions": np.broadcast_to(
                    np.arange(S, dtype=np.int32), (3, b, S)).copy(),
                "labels": rng.randint(0, cfg.vocab, (b, S)).astype(np.int32),
                "loss_mask": np.repeat((np.arange(S)[None] >= nv), b, 0)
                .astype(np.float32)}
    shape = (b, t, cfg.n_codebooks) if cfg.n_codebooks else (b, t)
    return {"tokens": rng.randint(0, cfg.vocab, shape).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab, shape).astype(np.int32)}


def to_jax(batch, dtype):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "vision_embeds" in out:
        out["vision_embeds"] = out["vision_embeds"].astype(dtype)
    return out


def to_torch(batch, dtype):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "vision_embeds" in out:
        out["vision_embeds"] = out["vision_embeds"].to(getattr(torch, dtype))
    return out


def configs(arch, dtype):
    return (jax_smoke(arch).replace(dtype=dtype),
            torch_smoke(arch).replace(dtype=dtype))


def bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def as_np(t):
    return t.detach().to(torch.float32).numpy()


def port_loss_fn(model, remat="none"):
    def loss_fn(p, b):
        logits, _ = model.apply(p, b, remat=remat)
        return cross_entropy(model.cfg, logits, b)
    return loss_fn


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("case", ["plain", "mask", "audio", "vlm_mask"])
def test_cross_entropy_matches_reference(case):
    rng = np.random.RandomState(1)
    V = 37
    shape = {"audio": (2, 5, 4), "vlm_mask": (2, 9)}.get(case, (3, 6))
    logits = (rng.randn(*shape, V) * 3).astype(np.float32)
    batch = {"labels": rng.randint(0, V, shape).astype(np.int32)}
    if case == "mask":
        batch["loss_mask"] = (rng.rand(*shape) > 0.4).astype(np.float32)
    if case == "vlm_mask":   # the vision rows (first 4) are left out
        batch["loss_mask"] = np.repeat(np.arange(9)[None] >= 4, 2, 0) \
            .astype(np.float32)
    want = float(jax_ce(None, jnp.asarray(logits),
                        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = cross_entropy(None, torch.from_numpy(logits),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= F32_TOL * abs(want)


def test_cross_entropy_empty_mask_is_zero():
    """``max(sum(mask), 1)``: an all-zero mask gives 0, not NaN."""
    logits = torch.randn(2, 3, 11)
    batch = {"labels": torch.zeros(2, 3, dtype=torch.int32),
             "loss_mask": torch.zeros(2, 3)}
    assert float(cross_entropy(None, logits, batch)) == 0.0


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step0", [0, 7])
def test_adamw_update_matches_reference(param_dtype, step0):
    rng = np.random.RandomState(5)
    shapes = {"w": (6, 5), "b": (5,), "blk": {"k": (3, 4, 2)}}

    def tree(scale):
        return {"w": rng.randn(*shapes["w"]) * scale,
                "b": rng.randn(*shapes["b"]) * scale,
                "blk": {"k": rng.randn(*shapes["blk"]["k"]) * scale}}
    p, g, m = tree(1.0), tree(0.3), tree(0.1)
    v = jax.tree.map(np.abs, tree(0.01))
    jdt = jnp.dtype(param_dtype)
    kw = dict(lr=3e-3, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=0.5)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), m),
              "v": jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), v),
              "step": jnp.int32(step0)}
    jnp_, jns, jmet = jax_adamw_update(JOpt(**kw), jg, jstate, jp)
    tp, tg = bridge(jp), bridge(jg)
    tstate = {"m": bridge(jstate["m"]), "v": bridge(jstate["v"]),
              "step": torch.tensor(step0, dtype=torch.int32)}
    tnp, tns, tmet = adamw_update(OptConfig(**kw), tg, tstate, tp)
    assert int(tns["step"]) == step0 + 1
    for k in ("grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            F32_TOL * abs(float(jmet[k]))
    tol = dict(rtol=1e-6, atol=1e-7) if param_dtype == "float32" else \
        dict(rtol=0, atol=0)
    for a, t in zip(jax.tree.leaves(jnp_), tree_flatten(tnp)[0]):
        assert t.dtype == getattr(torch, param_dtype)
        np.testing.assert_allclose(as_np(t), np.asarray(a, np.float32),
                                   **tol)
    for key in ("m", "v"):
        for a, t in zip(jax.tree.leaves(jns[key]),
                        tree_flatten(tns[key])[0]):
            np.testing.assert_allclose(as_np(t), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)


def test_adamw_init_and_state_dtype():
    oc = OptConfig(state_dtype="bfloat16")
    state = adamw_init(oc, {"w": torch.zeros(4, 4), "b": torch.zeros(4)})
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 130])
def test_cosine_lr_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100)
    got = float(cosine_lr(OptConfig(**kw), torch.tensor(step)))
    want = float(jax_cosine_lr(JOpt(**kw), step))
    assert abs(got - want) <= 1e-6
    if step == 0:
        assert got == 0.0
    if step == 10:
        assert abs(got - 1.0) < 1e-6
    if step >= 100:
        assert got < 1e-6


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("arch,micro", [("yi-9b", 1), ("yi-9b", 4),
                                        ("qwen30b-a3b", 1),
                                        ("qwen30b-a3b", 2)])
def test_train_step_matches_reference(arch, micro):
    """One whole step (loss, grads through AdamW, new params and state) in
    f32 against the reference's, at microbatches 1 and 4 (MoE 1 and 2).
    AdamW's first step moves each param by lr * g / (|g| + eps), about
    lr * sign(g), which is ill-conditioned where |g| is near eps: there
    the packages' f32 sum orders may move an element's step by a large
    part of lr. So every param is held within 2 * lr (one step either
    way), and all but 1e-3 of each leaf's elements within 2e-2 * lr."""
    jc, tc = configs(arch, "float32")
    jp = jax_build(jc).init(jax.random.PRNGKey(0))
    oc_kw = dict(lr=1e-3, warmup_steps=0)
    b = batch_np(jc, seed=3, b=4, t=16)
    jstep = jax.jit(jax_train_step(jc, oc=JOpt(**oc_kw), remat="none",
                                   microbatches=micro))
    jnp_, jns, jm = jstep(jp, jax_adamw_init(JOpt(**oc_kw), jp),
                          to_jax(b, "float32"))
    tp = bridge(jp)
    tstep = steps.make_train_step(tc, oc=OptConfig(**oc_kw), remat="none",
                                  microbatches=micro)
    tnp, tns, tm = tstep(tp, adamw_init(OptConfig(**oc_kw), tp),
                         to_torch(b, "float32"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        F32_TOL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    lr = oc_kw["lr"]
    for a, t in zip(jax.tree.leaves(jnp_), tree_flatten(tnp)[0]):
        diff = np.abs(as_np(t) - np.asarray(a, np.float32))
        assert diff.max() <= 2 * lr
        assert np.mean(diff > 2e-2 * lr) <= 1e-3
    for a, t in zip(jax.tree.leaves(jns["m"]), tree_flatten(tns["m"])[0]):
        np.testing.assert_allclose(as_np(t), np.asarray(a), rtol=2e-2,
                                   atol=1e-6)


def test_microbatches_match_full_step():
    """The reference's tests/test_microbatch.py inside the port (bf16):
    4 microbatches against one pass over the batch."""
    _, tc = configs("yi-9b", "bfloat16")
    params = torch_build(tc).init(torch.Generator().manual_seed(0))
    oc = OptConfig(lr=1e-3)
    b = to_torch(batch_np(tc, seed=1, b=8, t=16), "bfloat16")
    p1, _, m1 = steps.make_train_step(tc, oc=oc, remat="none")(
        params, adamw_init(oc, params), b)
    p4, _, m4 = steps.make_train_step(tc, oc=oc, remat="none",
                                      microbatches=4)(
        params, adamw_init(oc, params), b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    for a, c in zip(tree_flatten(p1)[0], tree_flatten(p4)[0]):
        np.testing.assert_allclose(as_np(a), as_np(c), rtol=5e-2, atol=1e-3)


def test_split_batch_vlm_positions():
    b = {"tokens": torch.arange(4 * 3).reshape(4, 3),
         "positions": torch.arange(3 * 4 * 5).reshape(3, 4, 5)}
    part = steps.split_batch(b, 2, 1)
    assert torch.equal(part["tokens"], b["tokens"][2:])
    assert torch.equal(part["positions"], b["positions"][:, 2:])


def test_quantised_config_cannot_train():
    _, tc = configs("qwen2-0.5b", "float32")
    tc = tc.replace(weight_quant="int8")
    params = torch_build(tc).init(torch.Generator().manual_seed(0))
    step = steps.make_train_step(tc, remat="none")
    with pytest.raises(ValueError, match="quantised"):
        step(params, adamw_init(OptConfig(), params),
             to_torch(batch_np(tc), "float32"))


def test_k1_gradient_and_k2_k3_refuse():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    w = torch.from_numpy(rng.randn(7, 3).astype(np.float32))
    dy = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx, dw = torch.autograd.grad(sm.streamed_matmul(xa, wa), (xa, wa), dy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    rx, rw = torch.autograd.grad(streamed_matmul_ref(xb, wb), (xb, wb), dy)
    torch.testing.assert_close(dx, rx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dw, rw, rtol=1e-6, atol=1e-6)
    q, s = sm.quantize_int8(w)
    with pytest.raises(RuntimeError, match="no gradient"):
        sm.streamed_matmul_int8(xa, q, s)
    qp, s4, z4 = sm.quantize_int4(w.repeat(2, 1))
    with pytest.raises(RuntimeError, match="no gradient"):
        sm.streamed_matmul_int4(torch.cat([xa, xa], 1), qp, s4, z4)
    with torch.no_grad():   # serving: allowed
        sm.streamed_matmul_int8(xa, q, s)


# ------------------------------------------------------- the segsum repair
def _segsum_in_place(x):
    """``segsum`` as it was before the repair: one buffer, in place."""
    T = x.shape[-1]
    ones = torch.ones((T, T), dtype=torch.bool)
    s = torch.where(torch.tril(ones, -1), x[..., :, None], 0.0)
    s.cumsum_(dim=-2)
    return s.masked_fill_(~torch.tril(ones), float("-inf"))


def _ssd_inputs(seed=0, Bsz=1, T=16, H=2, P=3, N=4):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(Bsz, T, H, P).astype(np.float32)),
            torch.from_numpy(-np.abs(rng.randn(Bsz, T, H))
                             .astype(np.float32) * 0.3),
            torch.from_numpy(rng.randn(Bsz, T, N).astype(np.float32)),
            torch.from_numpy(rng.randn(Bsz, T, N).astype(np.float32)))


def test_ssd_backward_raised_in_place_and_runs_now(monkeypatch):
    x, a, b, c = _ssd_inputs()
    x.requires_grad_(True)
    a.requires_grad_(True)
    with monkeypatch.context() as mp:
        mp.setattr(ssm, "segsum", _segsum_in_place)
        mp.setattr(ssm, "needs_grad", lambda *ts: False)
        y, _ = ssm.ssd(x, a, b, c, chunk=8)
        with pytest.raises(RuntimeError, match="inplace"):
            y.sum().backward()
    y, _ = ssm.ssd(x, a, b, c, chunk=8)
    gx, ga = torch.autograd.grad(y.square().sum(), (x, a))
    assert torch.isfinite(gx).all() and torch.isfinite(ga).all()


def test_ssd_no_grad_keeps_in_place_bits_and_allocations(monkeypatch):
    x, a, b, c = _ssd_inputs(seed=1, T=32)

    def run():
        with torch.no_grad():
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU],
                         profile_memory=True) as prof:
                y, st = ssm.ssd(x, a, b, c, chunk=8)
        alloc = sum(e.cpu_memory_usage for e in prof.events()
                    if e.cpu_memory_usage > 0)
        return y, st, alloc
    y, st, alloc = run()
    with monkeypatch.context() as mp:   # the parent's forms, in place
        mp.setattr(ssm, "segsum", _segsum_in_place)
        mp.setattr(ssm, "needs_grad", lambda *ts: False)
        y0, st0, alloc0 = run()
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert alloc == alloc0


# ---------------------------------------------------------------- launcher
def test_train_main_on_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        drv = train.main(["--arch", "qwen2-0.5b", "--steps", "5", "--seq",
                          "16", "--batch", "2", "--remat", "full",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                          "--inject-fault", "3", "--device", "cpu"])
    kinds = [k for _, k, _ in drv.events]
    # exact, though stragglers are wall-clock readings: the watch needs 5
    # timed steps before it can log one, and only steps 0-2 are timed
    # before the fault at 3, so none can come before the restart
    assert kinds[:2] == ["fault", "restart"] and drv.step == 5
    assert drv.events[1][0] == 2    # resumed from the step-2 checkpoint
    losses = [m["loss"] for m in drv.metrics_log]
    assert all(np.isfinite(losses)) and len(losses) == 6   # 3 + 3 replayed
    assert drv.metrics_log[2]["loss"] == drv.metrics_log[3]["loss"]
    assert "[train] qwen2-0.5b-smoke" in out.getvalue()


def test_train_main_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-0.5b", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_params_bridge_roundtrip_bf16():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
