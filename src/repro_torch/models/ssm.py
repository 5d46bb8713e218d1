"""State-space blocks: Mamba2 (SSD chunked form) and xLSTM (mLSTM/sLSTM).

The SSD scan is the reference's chunked state-space duality form: chunk-
batched products inside each chunk of ``SSD_CHUNK`` steps, and a
recurrence across chunks that is quadratic in their number (which is
small). Decode is a single-step state update (``ssd_step``). mLSTM reuses
the SSD (linear attention with a per-head scalar decay; the normaliser is
an extra ones-column on v). sLSTM is sequential: a Python loop over time
steps where the reference scans.

Everything follows the reference's rounding: the SSD casts its inputs to
f32 and its output back to the input's dtype; the conv sums bf16 products
one by one in k order; ``x * dt`` multiplies by ``dt`` cast to x's dtype;
sLSTM's recurrent product runs in the weights' dtype before its cast to
f32. The activations are jax's: ``silu`` and ``sigmoid`` as
``1 / (1 + exp(-x))`` op for op, ``softplus`` as ``logaddexp(x, 0)``,
``log_sigmoid`` as ``-softplus(-x)``, ``gelu`` with tanh.

As in the reference, mLSTM/sLSTM use sigmoid input gates in place of the
paper's exp gate and m-stabiliser.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import needs_grad
from repro_torch.models.common import dense_init, rmsnorm

SSD_CHUNK = 256


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x)


def _softplus(x):
    return torch.logaddexp(x, x.new_zeros(()))


def _log_sigmoid(x):
    return -_softplus(-x)


def _scalar(v, like):
    """A Python scalar as a 0-dim tensor of ``like``'s dtype: JAX rounds a
    weak-typed scalar to the array's dtype before the op, torch would keep
    it in f32."""
    return torch.tensor(v, dtype=like.dtype)


# ================================================================= SSD core
def segsum(x):
    """x: (..., T) -> (..., T, T); out[..., i, j] = sum_{k=j+1..i} x_k for
    j <= i, -inf above the diagonal. Serving keeps one (..., T, T) buffer,
    updated in place; where autograd records (``needs_grad``) the same ops
    run out of place, since the backward needs what the in-place forms
    would overwrite."""
    T = x.shape[-1]
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    s = torch.where(torch.tril(ones, -1), x[..., :, None], 0.0)
    if needs_grad(s):
        return torch.cumsum(s, dim=-2).masked_fill(~torch.tril(ones),
                                                   float("-inf"))
    s.cumsum_(dim=-2)
    return s.masked_fill_(~torch.tril(ones), float("-inf"))


def _exp_mul(s, other=None):
    """``exp(s) * other`` (or ``exp(s)``): in place on ``s`` when serving,
    out of place where autograd records (exp's backward reads its
    output)."""
    if needs_grad(s, other):
        e = torch.exp(s)
        return e if other is None else e * other
    s.exp_()
    return s if other is None else s.mul_(other)


def ssd(x, a, b, c, chunk=SSD_CHUNK, initial_state=None):
    """Chunked state-space duality scan.

    x: (B, T, H, P)   inputs (already dt-scaled for mamba; i-gated v for mLSTM)
    a: (B, T, H)      log-decay per step (<= 0)
    b: (B, T, N) or (B, T, H, N)   input maps (shared across heads or per-head)
    c: (B, T, N) or (B, T, H, N)   output maps
    Returns (y (B,T,H,P) in x's dtype, final_state (B,H,P,N) f32).
    """
    Bsz, T, H, Pd = x.shape
    per_head = b.ndim == 4
    chunk = min(chunk, T)
    assert T % chunk == 0
    nC = T // chunk
    f32 = torch.float32

    xc = x.reshape(Bsz, nC, chunk, H, Pd).to(f32)
    ac = a.reshape(Bsz, nC, chunk, H).movedim(-1, -2).to(f32)  # (B,nC,H,l)
    a_cum = torch.cumsum(ac, dim=-1)

    if per_head:
        bc = b.reshape(Bsz, nC, chunk, H, -1).to(f32)
        cc = c.reshape(Bsz, nC, chunk, H, -1).to(f32)
        s_diag = torch.einsum("bclhn,bcshn->bchls", cc, bc)
    else:
        bc = b.reshape(Bsz, nC, chunk, -1).to(f32)
        cc = c.reshape(Bsz, nC, chunk, -1).to(f32)
        s_diag = torch.einsum("bcln,bcsn->bcls", cc, bc)[:, :, None]

    w = _exp_mul(segsum(ac), s_diag)  # L * s_diag, (B, nC, H, l, s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", w, xc)
    del w

    # per-chunk aggregated states: (B, nC, H, P, N)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,nC,H,l)
    if per_head:
        states = torch.einsum("bcshn,bchs,bcshp->bchpn", bc, decay_states,
                              xc)
    else:
        states = torch.einsum("bcsn,bchs,bcshp->bchpn", bc, decay_states, xc)

    # inter-chunk recurrence (quadratic in nC; nC is small)
    if initial_state is None:
        initial_state = torch.zeros((Bsz, H, Pd, states.shape[-1]),
                                    dtype=f32, device=x.device)
    states = torch.cat([initial_state[:, None].to(f32), states], dim=1)
    chunk_sums = F.pad(a_cum[..., -1], (0, 0, 1, 0))  # (B, nC+1, H)
    decay_chunk = _exp_mul(segsum(chunk_sums.movedim(-1, 1)))  # (B,H,z,c)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # state -> output
    out_decay = torch.exp(a_cum)  # (B,nC,H,l)
    if per_head:
        y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", cc, prev_states,
                             out_decay)
    else:
        y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cc, prev_states,
                             out_decay)

    y = (y_diag + y_off).reshape(Bsz, T, H, Pd)
    return y.to(x.dtype), final_state


def ssd_step(state, x, a, b, c):
    """Single decode step. state: (B,H,P,N); x: (B,H,P); a: (B,H);
    b, c: (B,N) or (B,H,N). Returns (y (B,H,P), new_state f32)."""
    f32 = torch.float32
    state = state.to(f32)
    decay = torch.exp(a.to(f32))[..., None, None]
    if b.ndim == 2:
        add = torch.einsum("bhp,bn->bhpn", x.to(f32), b.to(f32))
        new = decay * state + add
        y = torch.einsum("bhpn,bn->bhp", new, c.to(f32))
    else:
        add = torch.einsum("bhp,bhn->bhpn", x.to(f32), b.to(f32))
        new = decay * state + add
        y = torch.einsum("bhpn,bhn->bhp", new, c.to(f32))
    return y.to(x.dtype), new


# ================================================================= conv
def causal_conv(x, w, conv_state=None, bias=None, valid_len=None):
    """Depthwise causal conv. x: (B, T, C); w: (K, C); bias: (C,) or None.

    conv_state: (B, K-1, C) previous inputs (decode) or None (zero
    history). Returns (y (B,T,C), new_state (B, K-1, C)). The products are
    rounded to the inputs' dtype and summed one at a time in k order, as
    the reference's ``sum``, then the bias is added; the new state is a
    view of a fresh tensor, never of ``conv_state``. With ``valid_len``
    the new state is the K-1 inputs before position ``valid_len``: a
    padded tail stays out of the history."""
    B, T, C = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=x.dtype,
                                 device=x.device)
    dt = torch.promote_types(conv_state.dtype, x.dtype)
    ext = torch.cat([conv_state.to(dt), x.to(dt)], dim=1)  # (B, K-1+T, C)
    y = sum(ext[:, k:k + T] * w[k] for k in range(K))
    if bias is not None:
        y = y + bias
    end = T if valid_len is None else valid_len
    return y, ext[:, end:end + K - 1]


# ================================================================= mamba2
def init_mamba_params(gen, cfg, dtype):
    """Separate w_z / w_xbc / w_dt projections, as the reference keeps
    them."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.n_ssm_heads
    conv_ch = di + 2 * n
    dev = gen.device
    return {
        "w_z": dense_init(gen, (d, di), 0, dtype),
        "w_xbc": dense_init(gen, (d, conv_ch), 0, dtype),
        "w_dt": dense_init(gen, (d, h), 0, dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), 0, dtype),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), 0, dtype),
    }


def _mamba_inner(params, cfg, u):
    """Shared projection/gate logic. u: (B, T, d_model)."""
    z = u @ params["w_z"]
    xBC = u @ params["w_xbc"]
    dt_raw = u @ params["w_dt"]
    return z, xBC, mamba_dt(params, dt_raw)


def mamba_dt(params, dt_raw):
    """The step size: ``softplus(dt + dt_bias)`` in f32, (B, T, h); no
    clamp (both published limits are (0, inf))."""
    return _softplus(dt_raw.to(torch.float32) + params["dt_bias"])


def group_heads(bc, h):
    """B or C of ``g`` groups, (B, T, g, N), as per-head maps (B, T, h,
    N): head ``j`` reads group ``j // (h / g)``."""
    return bc.repeat_interleave(h // bc.shape[2], dim=2)


def mamba_mix(params, cfg, z, xBC, dt, state=None, valid_len=None):
    """The Mamba-2 mixer between its projections: the causal conv (with
    its bias, where the layer has one) and SiLU over xBC; x, B and C, with
    B and C per group (``cfg.ssm_groups``); the SSD over ``x * dt`` from
    ``state``; the D skip; ``y * silu(z)`` RMS-normed over each group's
    ``d_inner / groups`` channels. One group is zamba2's block: shared B
    and C, one norm over d_inner, op for op.

    z: (B, T, di); xBC: (B, T, di + 2 g N); dt: (B, T, h) f32 from
    ``mamba_dt``; state: None or dict(conv, ssm), only read. Positions at
    or past ``valid_len`` (a padded tail) take dt = 0, so they leave the
    SSM state as it was, and stay out of the conv history. Returns (y (B,
    T, di), new_state dict)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    # the reference's ModelConfig, which the block also takes, has no
    # groups: one
    p, g = cfg.ssm_head_dim, getattr(cfg, "ssm_groups", 1)
    B_, T, _ = xBC.shape
    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = causal_conv(xBC, params["conv_w"], conv_state,
                                bias=params.get("conv_b"),
                                valid_len=valid_len)
    xBC = _silu(xBC)
    x, b, c = torch.split(xBC, [di, g * n, g * n], dim=-1)
    if g > 1:
        b = group_heads(b.reshape(B_, T, g, n), h)
        c = group_heads(c.reshape(B_, T, g, n), h)
    x = x.reshape(B_, T, h, p)
    if valid_len is not None and valid_len < T:
        dt = dt * (torch.arange(T, device=dt.device) < valid_len)[:, None]
    A = -torch.exp(params["a_log"])  # (h,)
    a = dt * A  # (B,T,h) log-decay
    xdt = x * dt[..., None].to(x.dtype)

    if T == 1 and state is not None:
        y, new_ssm = ssd_step(state["ssm"], xdt[:, 0], a[:, 0], b[:, 0],
                              c[:, 0])
        y = y[:, None]
    else:
        init = state["ssm"] if state is not None else None
        # a length past one SSD chunk and not a multiple of it: zero steps
        # (no input, no decay) fill the last chunk
        pad = -T % SSD_CHUNK if T > SSD_CHUNK else 0
        if pad:
            xdt, a, b, c = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                            for t in (xdt, a, b, c))
        y, new_ssm = ssd(xdt, a, b, c, initial_state=init)
        y = y[:, :T]
    y = y + x * params["d_skip"][:, None].to(x.dtype)
    y = y.reshape(B_, T, di)
    y = y * _silu(z)
    if g == 1:
        y = rmsnorm(y, params["gate_norm"], cfg.norm_eps)
    else:
        y = rmsnorm(y.reshape(B_, T, g, di // g),
                    params["gate_norm"].reshape(g, di // g),
                    cfg.norm_eps).reshape(B_, T, di)
    return y, {"conv": new_conv, "ssm": new_ssm}


def mamba_block(params, cfg, u, state=None):
    """u: (B, T, d). state: None or dict(conv=(B,K-1,C), ssm=(B,H,P,N)).

    Returns (out (B,T,d), new_state dict); ``state`` is only read."""
    z, xBC, dt = _mamba_inner(params, cfg, u)
    y, new_state = mamba_mix(params, cfg, z, xBC, dt, state)
    return y @ params["out_proj"], new_state


def init_mamba_state(cfg, batch, device, dtype=torch.float32):
    """Zero states: the conv history in bf16 (as the reference keeps it,
    whatever the model's dtype) and the SSM state in ``dtype``."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, n),
                           dtype=dtype, device=device),
    }


# ================================================================= mLSTM
def init_mlstm_params(gen, cfg, dtype):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    h = di // hd
    return {
        "up_proj": dense_init(gen, (d, 2 * di), 0, dtype),
        "wq": dense_init(gen, (di, di), 0, dtype),
        "wk": dense_init(gen, (di, di), 0, dtype),
        "wv": dense_init(gen, (di, di), 0, dtype),
        "w_gates": dense_init(gen, (di, 2 * h), 0, dtype),
        "out_norm": torch.ones((di,), dtype=dtype, device=gen.device),
        "down_proj": dense_init(gen, (di, d), 0, dtype),
    }


def mlstm_block(params, cfg, u, state=None):
    """u: (B,T,d). state: None or (B,H,hd+1,hd) matrix memory (+norm
    row), only read. Returns (out, new_state)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    h = di // hd
    B_, T, _ = u.shape
    up = u @ params["up_proj"]
    xin, z = torch.chunk(up, 2, dim=-1)
    q = (xin @ params["wq"]).reshape(B_, T, h, hd)
    q = q * _scalar(hd ** -0.5, q)
    k = (xin @ params["wk"]).reshape(B_, T, h, hd)
    v = (xin @ params["wv"]).reshape(B_, T, h, hd)
    gates = xin @ params["w_gates"]  # (B,T,2h)
    i_g = _sigmoid(gates[..., :h].to(torch.float32))
    logf = _log_sigmoid(gates[..., h:].to(torch.float32))  # (B,T,h) <= 0

    k_gated = k * i_g[..., None].to(k.dtype)
    v_aug = torch.cat([v, torch.ones((B_, T, h, 1), dtype=v.dtype,
                                     device=v.device)], dim=-1)

    if T == 1 and state is not None:
        y_aug, new_state = ssd_step(state, v_aug[:, 0], logf[:, 0],
                                    k_gated[:, 0], q[:, 0])
        y_aug = y_aug[:, None]
    else:
        y_aug, new_state = ssd(v_aug, logf, k_gated, q, initial_state=state)
    y, norm = y_aug[..., :hd], y_aug[..., hd:]
    y = y / torch.clamp_min(torch.abs(norm), 1.0)
    y = y.reshape(B_, T, di)
    y = rmsnorm(y * _silu(z), params["out_norm"], cfg.norm_eps)
    return y @ params["down_proj"], new_state


def init_mlstm_state(cfg, batch, device):
    di = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    return torch.zeros((batch, di // hd, hd + 1, hd), dtype=torch.float32,
                       device=device)


# ================================================================= sLSTM
def init_slstm_params(gen, cfg, dtype):
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    h = d // hd if d % hd == 0 else cfg.n_heads
    hd = d // h
    f = max(1, int(d * 4 / 3))
    return {
        "w_in": dense_init(gen, (d, 4 * d), 0, dtype),
        "r": dense_init(gen, (h, hd, 4 * hd), (1,), dtype),
        "ffn_up": dense_init(gen, (d, f), 0, dtype),
        "ffn_down": dense_init(gen, (f, d), 0, dtype),
    }


def slstm_block(params, cfg, u, state=None):
    """sLSTM with a block-diagonal recurrence, one time step at a time.

    state: None or dict(c, n, y) each (B, d) f32, only read. Returns (out,
    new_state)."""
    d = cfg.d_model
    r = params["r"]
    h = r.shape[0]
    hd = d // h
    B_, T, _ = u.shape
    f32 = torch.float32
    wx = (u @ params["w_in"]).reshape(B_, T, 4, d)  # preact (z,i,f,o)

    if state is None:
        state = {k: torch.zeros((B_, d), dtype=f32, device=u.device)
                 for k in ("c", "n", "y")}
    c, n, y = state["c"], state["n"], state["y"]
    ys = []
    for t in range(T):
        # recurrent contribution: block-diagonal per head
        yh = y.reshape(B_, h, hd)
        rec = torch.einsum("bhe,hef->bhf", yh.to(r.dtype), r) \
            .reshape(B_, h, 4, hd)
        rec = rec.movedim(1, 2).reshape(B_, 4, d).to(f32)
        pre = wx[:, t].to(f32) + rec
        z = torch.tanh(pre[:, 0])
        i = _sigmoid(pre[:, 1])
        f = _sigmoid(pre[:, 2])
        o = _sigmoid(pre[:, 3])
        c = f * c + i * z
        n = f * n + i
        y = o * c / torch.clamp_min(n, 1e-6)
        ys.append(y)
    out = torch.stack(ys, dim=1).to(u.dtype)  # (B,T,d)
    out = out + F.gelu(out @ params["ffn_up"], approximate="tanh") \
        @ params["ffn_down"]
    return out, {"c": c, "n": n, "y": y}
