#!/usr/bin/env python3
"""Where do qwen30b-a3b's int8-expert tokens start to depend on the
prefill tier? On one CUDA card, from the repo root:

    python3 tools/moe_tier_trace.py

Builds the port's kernels, draws qwen30b-a3b at its published widths and
12 of its 48 layers (``chip_smoke.py``'s phase-11 weights, experts
quantised to int8 per expert), opens an expert-granular session at 0.5x
of the weight bytes and prefills phase 11's first 64-token prompt twice,
with every layer-major prefill forced onto tier 32 (two chunks) and onto
tier 64 (one chunk). Each sub-layer's output rows are recorded and the
two runs compared layer by layer: the attention's output, the router's
expert ids and gates, the MoE output. Prints the first op whose rows
differ and by how much, then the last logits'. Prints only; exits 0 when
the comparison ran.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_tier_trace: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import Session
    from repro_torch.configs import get_config
    from repro_torch.core import (SYSTEMS, InferenceSetting, build_graph,
                                  planner, random_requests, run_install,
                                  total_weight_bytes)
    from repro_torch.core import engine as eng
    print(cs.card_line(), flush=True)
    cs.build_kernels()
    base = get_config(cs.MOE_ARCH).replace(n_layers=cs.MOE_LAYERS)
    kw = dict(expert_quant="int8")
    params = cs.moe_quantised(cs.moe_host_params(base), kw)
    cfg = base.replace(**kw)
    system = SYSTEMS["h100"].with_(link_gbps=cs.measure_link_gbps())
    budget = int(total_weight_bytes(build_graph(cfg, expert_granular=True))
                 * 0.5)
    prompt = random_requests(cfg.vocab, cs.N_REQ, cs.PROMPT_LEN,
                             cs.NEW_TOKENS, seed=0)[0].prompt
    tokens = torch.as_tensor(prompt, dtype=torch.int32)[None]

    record = []

    def hook(name, fn, pick):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            record.append((name, pick(out)))
            return out
        return wrapped

    real = {n: getattr(eng, n) for n in ("attn_prefill_step",
                                         "moe_route_prefill_step",
                                         "moe_combine_step")}
    real_tier = planner.Schedule.pick_prefill_tier
    runs = {}
    for tier in (32, 64):
        sess = Session.open(cfg, system, budget,
                            InferenceSetting(batch=cs.MAX_BATCH,
                                             context=cs.MAX_SEQ),
                            db=run_install(system), params=params,
                            max_seq=cs.MAX_SEQ, expert_granular=True)
        ex = sess.executor
        record.clear()
        planner.Schedule.pick_prefill_tier = \
            lambda self, *a, _t=tier, **k: _t
        eng.attn_prefill_step = hook("attention", real["attn_prefill_step"],
                                     lambda o: o.detach().clone())
        eng.moe_route_prefill_step = hook(
            "router", real["moe_route_prefill_step"],
            lambda o: (o[2].clone(), o[1][3].clone()))
        eng.moe_combine_step = hook("moe", real["moe_combine_step"],
                                    lambda o: o.detach().clone())
        try:
            last, _, _ = ex.prefill(tokens, prefill_mode="layer_major")
        finally:
            planner.Schedule.pick_prefill_tier = real_tier
            for n, fn in real.items():
                setattr(eng, n, fn)
        torch.cuda.synchronize()
        runs[tier] = (last.float(), list(record),
                      list(ex.stats.tiers_used))
        sess.close()
        cs.free_cuda()

    def rows(entries, name):
        """Per layer, the op's chunks joined along the token axis (the
        router's expert ids and gates flattened)."""
        got = [out for n, out in entries if n == name]
        per = len(got) // cfg.n_layers
        joined = []
        for i in range(cfg.n_layers):
            part = got[i * per:(i + 1) * per]
            if name == "router":
                joined.append(tuple(torch.cat([p[j].reshape(-1)
                                               for p in part])
                                    for j in range(2)))
            else:
                joined.append(torch.cat(part, dim=1))
        return joined

    (l32, r32, t32), (l64, r64, t64) = runs[32], runs[64]
    print(f"tiers used: {t32} and {t64}", flush=True)
    first = None
    for name in ("attention", "router", "moe"):
        a, b = rows(r32, name), rows(r64, name)
        for i, (x, y) in enumerate(zip(a, b)):
            if name == "router":
                same_ids = torch.equal(x[0], y[0])
                dg = (x[1].float() - y[1].float()).abs().max().item()
                print(f"layer {i} router: expert ids equal {same_ids}, "
                      f"gates max |diff| {dg:.3e}", flush=True)
                differs = not same_ids or dg > 0
            else:
                d = (x.float() - y.float()).abs()
                n = int((d > 0).sum().item())
                print(f"layer {i} {name}: {n} of {d.numel()} elements "
                      f"differ, max |diff| {d.max().item():.3e}", flush=True)
                differs = n > 0
            if differs and (first is None or i < first[0]):
                first = (i, name)
    print(f"first difference: {first}; last logits max |diff| "
          f"{(l32 - l64).abs().max().item():.3e}, argmax "
          f"{int(l32.argmax())} / {int(l64.argmax())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
