"""The plain reference of a Nemotron-H decoder in float32.

Written from the published description of the architecture (Hugging
Face's NemotronH): token embedding; per layer, as
``hybrid_override_pattern`` gives it, ``x + mixer(RMSNorm(x))`` with one
mixer of three kinds, and a final RMSNorm and an untied output head:

- ``M``, Mamba-2: one in-projection gives z, xBC and dt; a depthwise
  causal conv of width ``conv_kernel`` with its bias runs over xBC, then
  SiLU; xBC splits into x (heads of ``mamba_head_dim``), B and C (one of
  ``ssm_state_size`` per group, head h reading group h // (heads /
  groups)); dt = softplus(dt + dt_bias), unclamped (``time_step_limit``
  (0, inf)); A = -exp(A_log); the state runs the recurrence
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t + D
  x_t``, token by token from zero; then ``y * silu(z)`` RMS-normed over
  each group's channels, times its scale, and the out-projection;
- ``-``, MLP: ``down(relu(up(x))^2)``, no gate;
- ``*``, attention: grouped-query causal softmax attention scaled by
  1/sqrt(head_dim), with no positional encoding.

Every norm takes ``layer_norm_epsilon``. Departures from the published
model: everything is computed in float32 (the model computes in bf16,
and its kernels run the scan in chunks of ``chunk_size``; here the
recurrence is sequential, independent of any chunked form), and the
gated norm multiplies its scale before any rounding (the published norm
rounds to the input's dtype first).

It reads only the weights the benchmark drew (the host tree, each mixer
kind stacked over its layers) and the token ids, and computes layer by
layer on the given device, one layer's weights there at a time. TF32 is
switched off for its products. ``weights="fp8"`` is the control: every
layer's projections (Mamba-2 in and out, MLP, attention) computed in
float8 e4m3 as fp8 serving computes them, the weight rounded with one
scale per output column, the activation with one scale per row (absmax /
448 each), the product summed in f32; the conv, the scan's parameters,
the norms, the embedding and the head are kept as they are.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def _fp8(w: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale along ``dim`` (a
    weight (K, N): per output column; an activation (T, K), dim -1: per
    row), returned in f32."""
    scale = w.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _padded(x, spans, width):
    """The rows of each sequence (``spans`` of ``x``'s rows) in one zero-
    padded (S, width, ...) tensor."""
    out = x.new_zeros((len(spans), width) + tuple(x.shape[1:]))
    for j, (a, b) in enumerate(spans):
        out[j, :b - a] = x[a:b]
    return out


class Reference:
    """The forward of shapes ``s`` over the weight tree ``host``."""

    def __init__(self, s, host: dict, device, weights: str = "f32"):
        if weights not in ("f32", "fp8"):
            raise ValueError(weights)
        self.s, self.host, self.weights = s, host, weights
        self.device = torch.device(device)
        # each layer's index among the layers of its own kind
        seen, self.index = {}, []
        for k in s.pattern:
            self.index.append(seen.get(k, 0))
            seen[k] = seen.get(k, 0) + 1

    def _get(self, t, matrix=False):
        w = t.to(self.device, non_blocking=True).to(torch.float32)
        return _fp8(w) if matrix and self.weights == "fp8" else w

    def _mm(self, a, w):
        """A layer product; the control rounds its activation too."""
        return (_fp8(a, -1) if self.weights == "fp8" else a) @ w

    def _leaves(self, kind, j, matrices):
        tree = self.host["layers"][kind]
        return {k: self._get(v[j], matrix=k in matrices)
                for k, v in tree.items()}

    def _mamba(self, w, h, spans):
        """The Mamba-2 mixer over each sequence (its rows ``spans``)."""
        s = self.s
        di, C, H, P, N, G = (s.d_inner, s.conv_channels, s.m_heads,
                             s.m_head_dim, s.state, s.groups)
        z, xbc, dt = torch.split(self._mm(h, w["w_in"]), [di, C, H], -1)
        T = max(b - a for a, b in spans)
        K = s.conv
        # the causal conv from a zero history, and its bias
        xp = torch.nn.functional.pad(_padded(xbc, spans, T), (0, 0, K - 1, 0))
        conv = sum(xp[:, k:k + T] * w["conv_w"][k] for k in range(K))
        if "conv_b" in w:
            conv = conv + w["conv_b"]
        conv = torch.nn.functional.silu(conv)
        x, b, c = torch.split(conv, [di, G * N, G * N], -1)
        S = len(spans)
        x = x.reshape(S, T, G, H // G, P)
        b, c = b.reshape(S, T, G, N), c.reshape(S, T, G, N)
        dt = torch.nn.functional.softplus(_padded(dt, spans, T)
                                          + w["dt_bias"])
        dt = dt.reshape(S, T, G, H // G)
        A = -torch.exp(w["a_log"]).reshape(G, H // G)
        state = x.new_zeros((S, G, H // G, P, N))
        ys = []
        for t in range(T):
            dt_t = dt[:, t]
            state = state * torch.exp(dt_t * A)[..., None, None] \
                + (dt_t[..., None] * x[:, t])[..., None] \
                * b[:, t, :, None, None, :]
            ys.append(torch.einsum("sgkpn,sgn->sgkp", state, c[:, t]))
        y = torch.stack(ys, dim=1) \
            + x * w["d_skip"].reshape(G, H // G)[..., None]
        y = torch.cat([y[j, :bb - a].reshape(bb - a, di)
                       for j, (a, bb) in enumerate(spans)])
        y = (y * torch.nn.functional.silu(z)).reshape(-1, G, di // G)
        y = rms_norm(y, w["gate_norm"].reshape(G, di // G), s.eps)
        return self._mm(y.reshape(-1, di), w["w_out"])

    def _mlp(self, w, h):
        return self._mm(torch.relu(self._mm(h, w["w_up"])).square(),
                        w["w_down"])

    def _attention(self, w, h, spans):
        """Causal attention of each sequence, no positional encoding."""
        s = self.s
        hd, H, KV = s.head_dim, s.n_heads, s.n_kv
        q = self._mm(h, w["wq"]).view(-1, H, hd)
        k = self._mm(h, w["wk"]).view(-1, KV, hd)
        v = self._mm(h, w["wv"]).view(-1, KV, hd)
        out = torch.empty_like(q)
        for a, b in spans:
            T = b - a
            qs = q[a:b].transpose(0, 1)
            ks = k[a:b].transpose(0, 1).repeat_interleave(H // KV, dim=0)
            vs = v[a:b].transpose(0, 1).repeat_interleave(H // KV, dim=0)
            sc = (qs @ ks.transpose(1, 2)) * hd ** -0.5
            mask = torch.ones(T, T, dtype=torch.bool,
                              device=h.device).tril()
            sc = sc.masked_fill(~mask, float("-inf"))
            out[a:b] = (torch.softmax(sc, dim=-1) @ vs).transpose(0, 1)
        return self._mm(out.reshape(-1, H * hd), w["wo"])

    @torch.no_grad()
    def logits(self, seqs, score):
        """f32 logits of each sequence at its scored positions.
        ``seqs``: token id arrays; ``score``: for each, the positions whose
        next-token logits are wanted. Returns a list of (len(score[j]), V)
        tensors on the device."""
        s = self.s
        with no_tf32():
            spans, a = [], 0
            for t in seqs:
                spans.append((a, a + len(t)))
                a += len(t)
            ids = torch.cat([torch.as_tensor(t, dtype=torch.int64)
                             for t in seqs])
            x = self.host["embed"].index_select(0, ids) \
                .to(self.device).to(torch.float32)
            for i, kind in enumerate(s.pattern):
                j = self.index[i]
                h = rms_norm(x, self._get(self.host["layers"]["ln"][i]),
                             s.eps)
                if kind == "M":
                    w = self._leaves("mamba", j, ("w_in", "w_out"))
                    x = x + self._mamba(w, h, spans)
                elif kind == "-":
                    w = self._leaves("ffn", j, ("w_up", "w_down"))
                    x = x + self._mlp(w, h)
                else:
                    w = self._leaves("attn", j, ("wq", "wk", "wv", "wo"))
                    x = x + self._attention(w, h, spans)
                del w, h
            rows = torch.cat([torch.as_tensor(p, dtype=torch.int64) + a0
                              for p, (a0, _) in zip(score, spans)])
            h = rms_norm(x[rows.to(self.device)],
                         self._get(self.host["final_norm"]), s.eps)
            z = h @ self._get(self.host["unembed"])
            out, b = [], 0
            for p in score:
                out.append(z[b:b + len(p)])
                b += len(p)
            return out
