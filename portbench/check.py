"""How ``correct`` is decided for a served model.

Once the window has closed, a sample of the requests the program
finished, drawn from the seed and holding the longest of them, goes
through the plain reference (``reference/``) teacher-forced on each
prompt and its served tokens. The number compared is the widest gap by
which a served token's reference logit lies below the reference's best
logit at that position. Greedy serving gives gaps that only rounding
makes; a wrong token, cache or route gives gaps of the logits' own size.
"""
from __future__ import annotations

import numpy as np
import torch


def sample_requests(done, n: int, seed: int):
    """``n`` of the finished requests ``done`` (objects with ``prompt``
    and ``generated``), drawn from ``seed``, the longest first."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: (-(len(done[i].prompt)
                                    + len(done[i].generated)), i))
    rest = order[1:]
    rng = np.random.Generator(np.random.PCG64(abs(int(seed)) + 1))
    picked = rng.permutation(len(rest))[:max(0, n - 1)]
    return [done[order[0]]] + [done[rest[int(i)]] for i in sorted(picked)]


def teacher_forced(reqs):
    """(token sequences, scored positions, served tokens): each prompt
    with its served tokens but the last, the positions that predicted
    each served token, and those tokens."""
    seqs, score, served = [], [], []
    for r in reqs:
        T, g = len(r.prompt), [int(t) for t in r.generated]
        seqs.append(np.concatenate([np.asarray(r.prompt, np.int64),
                                    np.asarray(g[:-1], np.int64)]))
        score.append(np.arange(T - 1, T - 1 + len(g)))
        served.append(torch.as_tensor(g, dtype=torch.int64))
    return seqs, score, served


def gaps(ref_logits, chosen):
    """Per position: best reference logit - the reference's logit of the
    chosen token (0 where the chosen token is the reference's best)."""
    out = []
    for z, c in zip(ref_logits, chosen):
        c = c.to(z.device)
        out.append((z.max(dim=-1).values - z.gather(1, c[:, None])[:, 0])
                   .double().cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def summary(g):
    """The per-token gaps' statistics that a run logs."""
    if not len(g):
        return {}
    return {"tokens": int(len(g)), "max": float(g.max()),
            "mean": float(g.mean()), "p99": float(np.percentile(g, 99)),
            "p95": float(np.percentile(g, 95)),
            "share_nonzero": float((g > 0).mean())}


def served_gaps(reference, reqs):
    """The served tokens' gaps, position by position."""
    seqs, score, served = teacher_forced(reqs)
    return gaps(reference.logits(seqs, score), served)


def control_gaps(reference, control, reqs):
    """The gaps of the tokens the control (the reference at a lower
    precision) puts first at each position of the same sequences."""
    seqs, score, _ = teacher_forced(reqs)
    zc = control.logits(seqs, score)
    picks = [z.argmax(dim=-1) for z in zc]
    del zc
    return gaps(reference.logits(seqs, score), picks)
