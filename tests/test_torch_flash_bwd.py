"""K4's gradient on the CPU: ``FlashAttention`` (the autograd Function the
port's ``attend_flash`` runs through under autograd) with its plain
backward ``kernels/ref.py::flash_attention_bwd_ref``, against JAX's
gradients of the reference's attention.

- at T = 2112 (> ``FLASH_THRESHOLD``, so the port's ``attend`` takes K4):
  ``jax.grad`` of the reference's jnp ``attend_flash`` (the function the
  reference differentiates on its training path, in chunks of 704) against
  the port's ``attend`` grads, GQA and causal, f32 within 1e-5 and bf16
  within 2e-2 of max |grad|;
- at ragged lengths (T = 2081, no chunk divides it; the reference's
  ``attend_flash`` asserts it cannot run them) against ``jax.grad`` of the
  reference's ``attend_ref``;
- Tq != Tk both ways, non-causal, and every head dim the models use,
  against autograd through the plain forward ``flash_attention_ref``;
- the forward's lse is the scores' logsumexp, and the forward under
  autograd gives the bits of the forward without it;
- grads land in the model layout (B, T, heads, hd), and no kernel launch is
  counted on the CPU;
- chip_smoke.py's rounding limit for the backward kernel: the plain f32
  gradients rounded to bf16 stay within it, the same gradients without
  the last key tile (dq) or query block (dk, dv) do not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2


def qkv_np(B, T, H, KV, hd, seed=0, S=None):
    rng = np.random.RandomState(seed)
    S = T if S is None else S
    return (rng.randn(B, T, H, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32),
            rng.randn(B, S, KV, hd).astype(np.float32),
            rng.randn(B, T, H, hd).astype(np.float32))


def jax_grads(fn, q, k, v, dout, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(dout, dtype))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def torch_grads(fn, q, k, v, dout, dtype):
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(dt).requires_grad_(True)
            for a in (q, k, v)]
    out = fn(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dout).to(dt))
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def assert_grads_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attend_grads_match_reference_attend_flash(dtype, causal):
    B, T, H, KV, hd = 1, 2112, 4, 2, 16
    q, k, v, dout = qkv_np(B, T, H, KV, hd, seed=1)
    assert T > tattn.FLASH_THRESHOLD
    before = fa.flash_attention_backward.launches

    def ref(q, k, v):
        return jattn.attend_flash(q, k, v, causal=causal, q_chunk=704,
                                  kv_chunk=704)
    jo, jg = jax_grads(ref, q, k, v, dout, dtype)
    to, tg = torch_grads(lambda q, k, v: tattn.attend(q, k, v, causal),
                         q, k, v, dout, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert np.abs(to - jo).max() <= tol * np.abs(jo).max() + 1e-6
    assert_grads_close(tg, jg, tol)
    assert fa.flash_attention_backward.launches == before   # CPU: plain


@pytest.mark.parametrize("T", [2081, 2049])
def test_ragged_grads_match_reference_attend_ref(T):
    B, H, KV, hd = 1, 6, 2, 8
    q, k, v, dout = qkv_np(B, T, H, KV, hd, seed=T)
    _, jg = jax_grads(lambda q, k, v: jattn.attend_ref(q, k, v, causal=True),
                      q, k, v, dout, "float32")
    _, tg = torch_grads(lambda q, k, v: tattn.attend(q, k, v, True),
                        q, k, v, dout, "float32")
    assert_grads_close(tg, jg, F32_TOL)


@pytest.mark.parametrize("shape,causal", [
    ((1, 4, 2, 37, 90, 8), True),     # Tq < Tk (positions from 0)
    ((2, 4, 4, 90, 37, 16), True),    # Tq > Tk: rows past Tk see all keys
    ((1, 6, 3, 65, 129, 80), False),  # vision-like, non-causal, hd 80
    ((1, 4, 1, 70, 70, 112), True),   # zamba2's hd
    ((1, 2, 2, 64, 64, 128), True)])  # hd 128
def test_kernel_layout_grads_match_plain_autograd(shape, causal):
    """``flash_attention`` in K4's (B, H, T, hd) layout: the Function's
    grads against autograd through the plain forward."""
    B, H, KV, Tq, Tk, hd = shape
    rng = np.random.RandomState(7)
    q = rng.randn(B, H, Tq, hd).astype(np.float32)
    k = rng.randn(B, KV, Tk, hd).astype(np.float32)
    v = rng.randn(B, KV, Tk, hd).astype(np.float32)
    dout = rng.randn(B, H, Tq, hd).astype(np.float32)
    _, got = torch_grads(lambda q, k, v: fa.flash_attention(
        q, k, v, causal=causal, block_q=32, block_k=32), q, k, v, dout,
        "float32")
    _, want = torch_grads(lambda q, k, v: flash_attention_ref(
        q, k, v, causal=causal), q, k, v, dout, "float32")
    assert_grads_close(got, want, F32_TOL)


def test_lse_and_forward_bits():
    B, H, KV, T, hd = 2, 4, 2, 50, 16
    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, H, T, hd, generator=g)
    k = torch.randn(B, KV, T, hd, generator=g)
    v = torch.randn(B, KV, T, hd, generator=g)
    o, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o, flash_attention_ref(q, k, v, causal=True))
    s = torch.einsum("bkgtd,bksd->bkgts", q.reshape(B, KV, 2, T, hd), k) \
        * hd ** -0.5
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1)
                               .reshape(B, H, T), rtol=1e-6, atol=1e-6)
    qg = q.clone().requires_grad_(True)
    out = fa.flash_attention(qg, k, v, causal=True)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), fa.flash_attention(q, k, v,
                                                        causal=True))
    with torch.no_grad():   # serving: no Function, the plain call
        assert fa.flash_attention(qg, k, v, causal=True).grad_fn is None


def test_bwd_ref_gqa_sums_the_group():
    """dk / dv of a kv head sum its query heads: GQA against the same
    call with the kv heads repeated (MHA), summed back per group."""
    B, H, KV, T, hd = 1, 6, 2, 33, 8
    g = torch.Generator().manual_seed(4)
    q, dout = (torch.randn(B, H, T, hd, generator=g) for _ in range(2))
    k, v = (torch.randn(B, KV, T, hd, generator=g) for _ in range(2))
    _, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, dout, lse, causal=True)
    kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    dq2, dk2, dv2 = flash_attention_bwd_ref(q, kr, vr, dout, lse,
                                            causal=True)
    torch.testing.assert_close(dq, dq2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dk, dk2.reshape(B, KV, H // KV, T, hd).sum(2),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, dv2.reshape(B, KV, H // KV, T, hd).sum(2),
                               rtol=1e-5, atol=1e-6)


def test_bthd_grads_are_model_layout():
    B, T, H, KV, hd = 1, 40, 4, 2, 8
    q, k, v, dout = qkv_np(B, T, H, KV, hd, seed=9)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    from repro_torch.kernels.ops import flash_attention_bthd
    out = flash_attention_bthd(*args, causal=True)
    assert out.shape == (B, T, H, hd)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dout))
    for gr, a in zip(grads, args):
        assert gr.shape == a.shape
    _, want = torch_grads(lambda q, k, v: tattn.attend_ref(q, k, v, True),
                          q, k, v, dout, "float32")
    assert_grads_close([gr.numpy() for gr in grads], want, F32_TOL)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_round_limit_passes_rounding_and_rejects_a_dropped_tile(causal):
    cs = _chip_smoke()
    B, H, KV, T, hd, drop = 1, 4, 2, 200, 64, 8
    rng = np.random.default_rng(11)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s,
                                                          dtype=np.float32))
                     .to(torch.bfloat16)
                     for s in ((B, H, T, hd), (B, KV, T, hd), (B, KV, T, hd),
                               (B, H, T, hd)))
    _, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    refs, abss = cs.attention_bwd_f32(q, k, v, dout, lse, causal)
    for r, a in zip(refs, abss):
        assert cs.bwd_excess(r.bfloat16(), r, a, "bfloat16") <= 1.0
    (dq, _, _), _ = cs.attention_bwd_f32(q, k[:, :, :-drop],
                                         v[:, :, :-drop], dout, lse, causal)
    assert cs.bwd_excess(dq.bfloat16(), refs[0], abss[0], "bfloat16") > 1.0
    (_, dk, dv), _ = cs.attention_bwd_f32(
        q[:, :, :-drop], k, v, dout[:, :, :-drop],
        lse[:, :, :-drop].contiguous(), causal)
    assert max(cs.bwd_excess(dk.bfloat16(), refs[1], abss[1], "bfloat16"),
               cs.bwd_excess(dv.bfloat16(), refs[2], abss[2],
                             "bfloat16")) > 1.0
