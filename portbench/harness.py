"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

The system under test is ``repro_torch`` (the PyTorch/CUDA port): the
window drives ``ContinuousBatcher.step()`` of a ``Session`` opened at the
cell's VRAM budget, with a closed loop of clients from ``traffic.py``.
The harness stamps every send and every token arrival on the host clock
(``step()`` returns after the step's tokens were read back, so the
device has finished them), records a span per step and, with ``--trace
1``, the device's activity (``devtrace.py``) and K1's call shapes.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import check, devtrace, spec
from .traffic import ClosedLoop, warmup_requests
from .weights import draw_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def is_k1_kernel(name: str) -> bool:
    """K1's kernels by their demangled names: the bf16 tensor-core kernel
    with a dense bf16 weight (``mm_mma_kernel<DenseB, ...>``), and the f32
    tile kernel with a dense weight (``mm_kernel<float, DenseW<float>,
    ...>``, the MoE router). K2 and K3 take the same templates with
    quantised weights."""
    return ("mm_mma_kernel<" in name and "DenseB" in name) or \
        ("mm_kernel<float" in name and "DenseW" in name)


class RunError(RuntimeError):
    """A run that cannot report: no card, or fewer cards than the cell
    asks for."""


@dataclass
class Sent:
    """One request as its client sees it (host ns stamps)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    send_ns: int
    token_ns: list = field(default_factory=list)
    generated: list = field(default_factory=list)
    done_ns: Optional[int] = None
    error: Optional[str] = None


@dataclass
class Step:
    t0_ns: int
    t1_ns: int
    admitted: int            # requests admitted (prefilled) in the step
    admitted_tokens: int     # their prompt tokens
    tokens: int              # tokens the step delivered
    flops: int               # analytic operations of the step's tokens


@dataclass
class Run:
    """What the metric readers read."""
    seconds: float
    w0_ns: int               # window start
    end_ns: int              # w0 + seconds: tokens after it are not counted
    last_ns: int             # end of the last step (the traced span)
    setup_s: float
    requests: list
    steps: list
    counters: dict           # the executor's counters over the window
    trace: Optional[dict]    # devtrace.reduce's summary, traced runs only
    k1_calls: list           # (M, K, N, dtype) of K1 calls, traced runs


def _counters(batcher):
    st = batcher.ex.stats
    return {"streamed_bytes": st.streamed_bytes,
            "staged_bytes": st.staged_bytes,
            "at_use_bytes": st.at_use_bytes,
            "decode_iterations": len(batcher.iter_moved_bytes),
            "expert_hits": st.expert_hits,
            "expert_demanded": st.expert_demanded,
            "demanded_expert_bytes": st.demanded_expert_bytes}


def _window_counters(batcher, before):
    """The counters' growth over the window; ``decode_moved_bytes``: the
    host-to-device bytes of the window's decode iterations (streamed,
    demanded and at-use copies: ``ContinuousBatcher.iter_moved_bytes``)."""
    now = _counters(batcher)
    out = {k: now[k] - before[k] for k in now}
    out["decode_moved_bytes"] = int(sum(
        batcher.iter_moved_bytes[before["decode_iterations"]:]))
    return out


def ledger_gap(sess) -> int:
    """streamed bytes - (each pass's static plan bytes not pinned +
    demanded expert bytes): 0 when the link carried what the plan priced
    (over the whole session, warm-up included)."""
    ex = sess.executor
    pinned = {p.sub.name for p in sess.schedule.pinned_placements()}
    static = 0
    for t in ex.stats.tiers_used:
        static += sum(p.sub.weight_bytes for p in
                      sess.schedule.tiers[t].plan.static_stream_order()
                      if p.sub.name not in pinned)
    return int(ex.stats.streamed_bytes - static
               - ex.stats.demanded_expert_bytes)


class _K1Log:
    """K1's call shapes, logged by a wrapper around its Python entry
    while the window is traced."""

    def __init__(self):
        import repro_torch.kernels.streamed_matmul as smm
        self.module, self.orig, self.calls = smm, smm._k1, []

        def logged(x, w):
            self.calls.append((int(x.shape[0]), int(x.shape[1]),
                               int(w.shape[-1]),
                               str(x.dtype).replace("torch.", "")))
            return self.orig(x, w)
        smm._k1 = logged

    def close(self):
        self.module._k1 = self.orig


def _step_flops(arch, s, events, sent):
    """Analytic operations of one step's delivered tokens, counted by the
    architecture's file."""
    flops = 0
    for ev in events:
        r = sent.get(ev.rid)
        if r is None or ev.error is not None:
            continue
        T = len(r.prompt)
        if ev.index == 0:
            flops += arch.prompt_flops(s, T)
        else:
            flops += arch.token_flops(s, T + ev.index) + arch.head_flops(s)
    return flops


def serve_window(batcher, loop: ClosedLoop, seconds: float, arch, s,
                 on_start=None):
    """The measured window: every client keeps one request in flight;
    a finished request's client sends its next at once. Returns (sent
    requests by rid, steps, w0, end, last)."""
    from repro_torch.core.serving import Request
    sent = {}

    def send():
        rid, prompt, n = loop.next()
        t = time.time_ns()
        sent[rid] = Sent(rid, prompt, n, t)
        batcher.submit([Request(rid=rid, prompt=prompt, max_new_tokens=n)])

    if on_start is not None:
        on_start()
    w0 = time.time_ns()
    end = w0 + int(seconds * 1e9)
    for _ in range(loop.clients):
        send()
    steps = []
    while True:
        pending = {r.rid for r in batcher.pending}
        t0 = time.time_ns()
        events = batcher.step()
        t1 = time.time_ns()
        admitted = pending - {r.rid for r in batcher.pending}
        finished = 0
        for ev in events:
            r = sent[ev.rid]
            if ev.error is not None:
                r.error, r.done_ns = ev.error, t1
                finished += 1
                continue
            r.token_ns.append(t1)
            r.generated.append(int(ev.token))
            if ev.done:
                r.done_ns = t1
                finished += 1
        steps.append(Step(t0, t1, len(admitted),
                          sum(len(sent[rid].prompt) for rid in admitted),
                          sum(1 for ev in events if ev.error is None),
                          _step_flops(arch, s, events, sent)))
        if t1 >= end:
            return sent, steps, w0, end, t1
        for _ in range(finished):
            send()


def warm_up(batcher, mix, vocab):
    """The cell's own shapes: the mix's warm-up prompts, a batch of them
    at a time, so prefill runs at each chunk shape and decode at 1 to
    max_batch active slots."""
    from repro_torch.core.serving import Request
    batcher.submit([Request(rid=rid, prompt=p, max_new_tokens=n)
                    for rid, p, n in warmup_requests(mix, vocab)])
    while batcher.has_work:
        batcher.step()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def off_dtype_weight_bytes(sess, dtype: str) -> int:
    """Bytes of the layer weight matrices (the ``w*`` leaves) that the
    program serves from in another dtype than the configuration states:
    0 for a program that serves the stated weights; the port's int8 and
    int4 paths hold codes there. Read from the executor's host copies,
    which every sub-layer is pinned or streamed from."""
    want = getattr(torch, dtype)
    n = 0

    def walk(tree):
        nonlocal n
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif str(k).startswith("w") and v.dtype != want:
                n += v.numel() * v.element_size()
    for lp in sess.executor.layer_params:
        walk(lp)
    return n


def quantised_params(host, weight_quant, device):
    """``host`` with every layer's FFN quantised by the port's own
    install-time quantiser (``weight_quant``), on the card, then back in
    pinned host memory; the other leaves are shared."""
    from repro_torch.core.executor import pin_host_tree
    from repro_torch.models.transformer import quantize_params
    ffn = {k: v.to(device) for k, v in host["layers"]["ffn"].items()}
    q = quantize_params({"layers": {"ffn": ffn}},
                        weight_quant)["layers"]["ffn"]
    q = pin_host_tree({k: v.cpu() for k, v in q.items()}, device)
    del ffn
    return {**host, "layers": {**host["layers"], "ffn": q}}


def run_cell(root, workload, seed, seconds, trace=False, device=None,
             bench_dir=spec.HERE, t_process=None, log=None,
             fp8_control=False, weight_quant="fp16"):
    """One run. Returns (result dict, checks): the result line's keys
    and the compared numbers as (name, value, limit, kind), kind
    ``"max"`` (value <= limit) or ``"min"`` (value >= limit).
    ``fp8_control``: also read the gaps of the reference computed in fp8
    on the same sample; ``weight_quant``: serve through the port's own
    quantised FFN path. Both are the check's controls, which the
    benchmark's own runs do not run."""
    t_process = time.time() if t_process is None else t_process
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = spec.load_cell(root, workload, bench_dir)
    arch = spec.architecture(cell.config, bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell asks for {cell.chips} cards, "
                           f"{torch.cuda.device_count()} present")
        device = "cuda"
    device = torch.device(device)
    if trace and device.type != "cuda":
        raise RunError("a traced run needs the card")

    from repro_torch import Session
    from repro_torch.core import InferenceSetting, build_graph
    from repro_torch.core import total_weight_bytes

    s = arch.shapes(cell.config, cell.config_name)
    cfg = arch.port_config(cell.config, s)
    mix = cell.traffic
    t_start = time.time()
    host = draw_weights(arch.leaves(s), seed, device)
    served = host
    if weight_quant != "fp16":
        cfg = cfg.replace(weight_quant=weight_quant)
        served = quantised_params(host, weight_quant, device)
    t_weights = time.time()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    graph_bytes = total_weight_bytes(build_graph(cfg,
                                                 expert_granular=s.moe))
    budget = int(mix["budget_fraction"] * graph_bytes)
    log(f"cell {cell.name}: {s.n_layers} layers, graph {graph_bytes} B, "
        f"budget {budget} B ({mix['budget_fraction']}x), seed {seed}")
    max_seq, max_batch = int(mix["max_seq"]), int(mix["max_batch"])
    sess = Session.open(cfg, "h100", budget,
                        InferenceSetting(batch=max_batch, context=max_seq),
                        params=served, max_seq=max_seq, device=device,
                        kv_layout=mix.get("kv_layout", "stacked"))
    batcher = sess.batcher(max_batch=max_batch)
    t_open = time.time()
    loop = ClosedLoop(mix, s.vocab, seed)
    if loop.longest() > max_seq:
        raise ValueError("the mix's longest request exceeds max_seq")
    warm_up(batcher, mix, s.vocab)
    _sync(device)
    log(f"set-up phases: imports {t_start - t_process:.3f} s, weights "
        f"{t_weights - t_start:.3f} s, session {t_open - t_weights:.3f} s, "
        f"warm-up {time.time() - t_open:.3f} s")

    before = _counters(batcher)
    prof, k1log = None, None

    def on_start():
        nonlocal prof, k1log
        if trace:
            prof = devtrace.start()
            k1log = _K1Log()

    sent, steps, w0, end, last = serve_window(batcher, loop, seconds, arch,
                                              s, on_start)
    if k1log is not None:
        k1log.close()
    counters = _window_counters(batcher, before)
    log(f"window counters {json.dumps(counters)}")
    setup_s = w0 / 1e9 - t_process
    summary = None
    if prof is not None:
        spans = [(st.t0_ns, st.t1_ns,
                  "admitting_step" if st.admitted else "decode_step")
                 for st in steps]
        summary = devtrace.reduce(prof, w0, last, spans, is_k1_kernel)
        del prof
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    gap_bytes = ledger_gap(sess)
    log(f"guarantee streamed_minus_plan_bytes {gap_bytes} (0 when the link "
        f"carried exactly the static plan plus demanded experts)")
    log(f"guarantee peak_bytes {peak} budget_bytes {budget} "
        f"pinned_bytes {int(sess.schedule.pinned_bytes)}")
    off_dtype = off_dtype_weight_bytes(sess, s.dtype)
    run = Run(seconds=seconds, w0_ns=w0, end_ns=end, last_ns=last,
              setup_s=setup_s, requests=list(sent.values()), steps=steps,
              counters=counters, trace=summary,
              k1_calls=k1log.calls if k1log else [])

    # the program's state goes before the reference runs
    del batcher, sess, served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(run, arch.Reference(s, host, device),
                     cell.config.get("check", {}), seed, log,
                     arch.Reference(s, host, device, "fp8")
                     if fp8_control else None)
    checks.append(("off_dtype_weight_bytes", off_dtype, 0, "max"))
    reported = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in reported:
        value = spec.metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = len(run.requests)
    failed = sum(1 for r in run.requests if r.error is not None)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(_holds(c) for c in checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    return result, checks


# the numbers a configuration's ``check`` block may set a limit on, each
# a statistic of the per-token gaps (check.py)
GAP_NUMBERS = {"max_logit_gap": lambda g: float(g.max()),
               "mean_logit_gap": lambda g: float(g.mean())}


def compare(run, reference, limits, seed, log, control=None):
    """The compared numbers: the statistics of the served tokens' gaps
    against ``reference`` (the architecture's plain reference) that the
    configuration limits, the requests that failed, and that the window
    finished something to compare. With a ``control`` (the reference with
    fp8 layer weights), also the same statistics of its tokens on the
    same sample."""
    done = [r for r in run.requests
            if r.done_ns is not None and r.done_ns <= run.last_ns
            and r.error is None]
    sample = check.sample_requests(done, int(limits.get("sample_requests",
                                                          8)), seed)
    t0 = time.perf_counter()
    g = check.served_gaps(reference, sample) if sample else np.zeros(0)
    log(f"reference: {len(sample)} of {len(done)} finished requests, "
        f"{len(g)} served tokens, {time.perf_counter() - t0:.1f} s")
    log(f"program gaps {json.dumps(check.summary(g))}")
    limited = {k: float(limits[k]) for k in GAP_NUMBERS
               if limits.get(k) is not None} \
        or {"max_logit_gap": float("inf")}
    out = [(k, GAP_NUMBERS[k](g) if len(g) else float("inf"), lim, "max")
           for k, lim in limited.items()]
    out += [("failed_requests", sum(1 for r in run.requests
                                    if r.error is not None), 0, "max"),
            ("compared_tokens", len(g), 1, "min")]
    if control is not None and sample:
        gc_ = check.control_gaps(reference, control, sample)
        log(f"control gaps {json.dumps(check.summary(gc_))}")
        out += [(f"control_{k}", GAP_NUMBERS[k](gc_), lim, "min")
                for k, lim in limited.items()]
    return out


def _holds(c):
    _, value, limit, kind = c
    return value <= limit if kind == "max" else value >= limit


def _finite(x):
    """JSON has no infinity: an unset limit or an empty comparison is
    written as null."""
    return None if isinstance(x, float) and math.isinf(x) else x


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t_process=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = spec.HERE.parent
    try:
        result, checks = run_cell(root, a.workload, a.seed, a.seconds,
                                  trace=bool(a.trace), t_process=t_process)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    result["checks"] = {name: {"value": _finite(value),
                               "limit": _finite(limit),
                               "holds": _holds((name, value, limit, kind))}
                        for name, value, limit, kind in checks}
    for name, value, limit, kind in checks:
        rel = "<=" if kind == "max" else ">="
        print(f"check {name} {value!r} limit {rel} {limit!r}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

