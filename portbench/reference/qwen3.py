"""The plain reference of a Qwen3 decoder, dense or MoE, in float32.

Written from the published description of the architecture (Hugging
Face's Qwen3 and Qwen3-MoE): token embedding; per layer a pre-norm
residual attention block (RMSNorm, q/k/v projections, RMSNorm over each
head of q and k, rotary positions on the two halves of each head,
grouped-query causal softmax attention scaled by 1/sqrt(head_dim), output
projection) and a pre-norm residual SwiGLU block (dense, or a softmax
router whose top-k experts' gates are renormalised to sum to one, every
routed token computed: no capacity, nothing dropped); a final RMSNorm and
the output head.

It reads only the weights the benchmark drew (the host tree) and the
token ids, and computes layer by layer on the given device, one layer's
weights there at a time, so it fits beside whatever else is live. TF32 is
switched off for its products. ``weights="fp8"`` is the control, every
layer product computed in float8 e4m3 as fp8 serving computes it: the
weight rounded with one scale per output column, the activation with one
scale per row (absmax / 448 each), the product summed in f32; the
embedding, the f32 router and the head are kept as they are.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def _fp8(w: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale along ``dim`` (a
    weight (..., K, N): per output column; an activation (T, K), dim -1:
    per row), returned in f32."""
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


def rotate(x, pos, theta):
    """Rotary positions on (T, heads, hd): the first and second halves of
    each head are the pair's two coordinates."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (pos.to(torch.float64)[:, None] * inv[None, :])[:, None, :]
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class Reference:
    """The forward of shapes ``s`` over the weight tree ``host``."""

    def __init__(self, s, host: dict, device, weights: str = "f32"):
        if weights not in ("f32", "fp8"):
            raise ValueError(weights)
        self.s, self.host, self.weights = s, host, weights
        self.device = torch.device(device)

    def _get(self, t, matrix=False):
        w = t.to(self.device, non_blocking=True).to(torch.float32)
        return _fp8(w) if matrix and self.weights == "fp8" else w

    def _mm(self, a, w):
        """A layer product; the control rounds its activation too."""
        return (_fp8(a, -1) if self.weights == "fp8" else a) @ w

    def _layer(self, i):
        lp, g = self.host["layers"], self._get
        out = {"ln1": g(lp["ln1"][i]), "ln2": g(lp["ln2"][i])}
        out.update({k: g(lp["attn"][k][i], matrix=True)
                    for k in ("wq", "wk", "wv", "wo")})
        if self.s.qk_norm:
            out["q_norm"] = g(lp["attn"]["q_norm"][i])
            out["k_norm"] = g(lp["attn"]["k_norm"][i])
        key = "moe" if self.s.moe else "ffn"
        for k in ("w_gate", "w_up", "w_down"):
            out[k] = g(lp[key][k][i], matrix=True)
        if self.s.moe:
            out["router"] = g(lp["moe"]["router"][i])
        return out

    def _attention(self, w, x, spans):
        """Causal attention of each sequence (its rows ``spans``)."""
        s = self.s
        hd, H, KV = s.head_dim, s.n_heads, s.n_kv
        h = rms_norm(x, w["ln1"], s.eps)
        q = self._mm(h, w["wq"]).view(-1, H, hd)
        k = self._mm(h, w["wk"]).view(-1, KV, hd)
        v = self._mm(h, w["wv"]).view(-1, KV, hd)
        if s.qk_norm:
            q = rms_norm(q, w["q_norm"], s.eps)
            k = rms_norm(k, w["k_norm"], s.eps)
        out = torch.empty_like(q)
        for a, b in spans:
            T = b - a
            pos = torch.arange(T, device=x.device)
            qs = rotate(q[a:b], pos, s.rope_theta).transpose(0, 1)
            ks = rotate(k[a:b], pos, s.rope_theta).transpose(0, 1)
            vs = v[a:b].transpose(0, 1)
            ks = ks.repeat_interleave(H // KV, dim=0)
            vs = vs.repeat_interleave(H // KV, dim=0)
            sc = (qs @ ks.transpose(1, 2)) * hd ** -0.5
            mask = torch.ones(T, T, dtype=torch.bool,
                              device=x.device).tril()
            sc = sc.masked_fill(~mask, float("-inf"))
            out[a:b] = (torch.softmax(sc, dim=-1) @ vs).transpose(0, 1)
        return x + self._mm(out.reshape(-1, H * hd), w["wo"])

    def _swiglu(self, h, wg, wu, wd):
        a = torch.nn.functional.silu(self._mm(h, wg)) * self._mm(h, wu)
        return self._mm(a, wd)

    def _ffn(self, w, x):
        s = self.s
        h = rms_norm(x, w["ln2"], s.eps)
        if not s.moe:
            return x + self._swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
        probs = torch.softmax(h @ w["router"], dim=-1)
        gates, experts = torch.topk(probs, s.top_k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in torch.unique(experts).tolist():
            rows, slot = torch.nonzero(experts == e, as_tuple=True)
            ye = self._swiglu(h[rows], w["w_gate"][e], w["w_up"][e],
                              w["w_down"][e])
            out.index_add_(0, rows, ye * gates[rows, slot][:, None])
        return x + out

    @torch.no_grad()
    def logits(self, seqs, score):
        """f32 logits of each sequence at its scored positions.
        ``seqs``: token id arrays; ``score``: for each, the positions whose
        next-token logits are wanted. Returns a list of (len(score[j]), V)
        tensors on the device."""
        with no_tf32():
            spans, a = [], 0
            for t in seqs:
                spans.append((a, a + len(t)))
                a += len(t)
            ids = torch.cat([torch.as_tensor(t, dtype=torch.int64)
                             for t in seqs]).to(self.device)
            x = self.host["embed"].index_select(0, ids.cpu()) \
                .to(self.device).to(torch.float32)
            for i in range(self.s.n_layers):
                w = self._layer(i)
                x = self._attention(w, x, spans)
                x = self._ffn(w, x)
                del w
            rows = torch.cat([torch.as_tensor(p, dtype=torch.int64) + a0
                              for p, (a0, _) in zip(score, spans)])
            h = rms_norm(x[rows.to(self.device)],
                         self._get(self.host["final_norm"]), self.s.eps)
            head = self._get(self.host["embed"]).T if self.s.tie \
                else self._get(self.host["unembed"])
            z = h @ head
            out, b = [], 0
            for p in score:
                out.append(z[b:b + len(p)])
                b += len(p)
            return out
