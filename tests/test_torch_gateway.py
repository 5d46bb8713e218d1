"""The port's serving gateway against the JAX package's, on the CPU (smoke
yi-9b, f32 weights bridged from the reference's, numpy-seeded prompts).

Held equal to the reference: the wire schema (parsed requests, status
codes and error codes, response and chunk bodies, SSE bytes), the
broker's ledger and picks under one fake-clock script, the queue-aware
tier picks on both packages' schedules, and the tokens of a staggered
streamed wave through both gateways. Inside the port: the wave equals a
direct ``ContinuousBatcher.serve``, with queue-aware picks on and off;
``step`` equals ``serve`` and its events cover every token; TTFT;
cancel; unary equals stream; exactly k 429s; the rate limit over HTTP; a
disconnect frees paged KV; drain answers 503 (and its deadline cancels);
re-budget over HTTP; ``/metrics`` carries the speculative counters; a
``gateway.pump`` fault and a per-request fault fail only their tickets;
``/healthz`` reports the degradation.
"""
import asyncio
import json

import jax
import numpy as np
import pytest
import torch

import repro
import repro.gateway as jgw
from repro.configs import get_smoke_config as jax_smoke
from repro.core import CLI2 as JCLI2
from repro.core import InferenceSetting as JSetting
from repro.core import run_install as jax_install
from repro.core.planner import Plan as JPlan
from repro.core.planner import Schedule as JSchedule
from repro.core.planner import TierEntry as JTierEntry
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.core.serving import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import Session
from repro_torch import gateway as tgw
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import (CLI2, DEGRADATION_RUNGS, FaultPlan, FaultSpec,
                              InferenceSetting, RecoveryPolicy,
                              TimingEstimator, build_graph, build_schedule,
                              run_install)
from repro_torch.core.planner import Plan, Schedule, TierEntry
from repro_torch.core.serving import ContinuousBatcher, Request
from repro_torch.gateway import (Gateway, InprocClient, QueueFull,
                                 RateLimited, RequestBroker, encode_text,
                                 parse_stream)
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

MODEL = "yi-9b-smoke"
VOCAB = 512
SETTING = dict(batch=2, context=64)
FAST = RecoveryPolicy(sleep=lambda s: None, backoff_base_s=0.0)


def run(coro):
    return asyncio.run(coro)


# ===================================================================== wire
BAD_BODIES = [
    b"{nope", b"[1,2]",
    {"messages": [{"role": "user", "content": "hi"}]},
    {"model": MODEL}, {"model": MODEL, "messages": []},
    {"model": MODEL, "messages": [{"role": "user"}]},
    {"model": MODEL, "token_ids": []},
    {"model": MODEL, "token_ids": [1, VOCAB]},
    {"model": MODEL, "token_ids": [1, -1]},
    {"model": MODEL, "token_ids": [1], "max_tokens": 0},
    {"model": MODEL, "token_ids": [1], "max_tokens": True},
    {"model": MODEL, "token_ids": [1], "stream": "yes"},
    {"model": MODEL, "token_ids": [1], "deadline_s": -2},
    {"model": "gpt-oops", "token_ids": [1]},
    {"model": MODEL, "token_ids": [1] * 60, "max_tokens": 8}]
GOOD_BODIES = [
    {"model": MODEL, "token_ids": [3, 1, 4], "max_tokens": 2,
     "stream": True, "priority": 2, "deadline_s": 1.5, "user": "alice"},
    {"model": MODEL, "messages": [{"role": "user", "content": "3 1 4"}]},
    {"model": MODEL, "messages": [{"role": "system", "content": "be terse"},
                                  {"role": "user", "content": "hello world"}]}]


def parse(pkg, obj):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    return pkg.parse_chat_request(body, model_ids=[MODEL], vocab=VOCAB,
                                  max_seq=64)


@pytest.mark.parametrize("i", range(len(BAD_BODIES)))
def test_parse_errors_equal_the_reference(i):
    """The status-code split (400 malformed, 404 unknown model, 413 over
    the window) and the error bodies, byte for byte."""
    errs = []
    for pkg in (jgw, tgw):
        with pytest.raises(pkg.GatewayError) as e:
            parse(pkg, BAD_BODIES[i])
        errs.append((e.value.status, e.value.code,
                     json.dumps(e.value.body())))
    assert errs[0] == errs[1]
    assert errs[1][0] in (400, 404, 413)


@pytest.mark.parametrize("i", range(len(GOOD_BODIES)))
def test_parse_and_bodies_equal_the_reference(i):
    j, t = parse(jgw, GOOD_BODIES[i]), parse(tgw, GOOD_BODIES[i])
    assert vars(t) == vars(j)
    assert all(0 <= tok < VOCAB for tok in t.prompt_tokens)
    for fn, args in (("completion_body", ("id-1", MODEL, [5, 6, 7], 3, 99)),
                     ("chunk_body", ("id-1", MODEL, 5, 0, 1234)),
                     ("chunk_body", ("id-1", MODEL, 6, 3, 1234, "length")),
                     ("models_body", ([MODEL],))):
        jb = getattr(jgw, fn)(*args)
        tb = getattr(tgw, fn)(*args)
        jb.pop("created", None), tb.pop("created", None)
        assert json.dumps(tb) == json.dumps(jb), fn
    assert tgw.encode_text("hello world", VOCAB) == \
        jgw.encode_text("hello world", VOCAB)
    assert tgw.decode_tokens([3, 1, 4]) == jgw.decode_tokens([3, 1, 4])


def test_sse_framing_equals_the_reference():
    for obj in ({"a": 1}, {"b": [2, 3]}, {"error": {"message": "x"}}):
        assert tgw.format_event(obj) == jgw.format_event(obj)
    assert tgw.DONE_EVENT == jgw.DONE_EVENT
    payload = tgw.format_event({"a": 1}) + tgw.format_event({"b": [2, 3]}) \
        + tgw.DONE_EVENT
    assert parse_stream(payload) == jgw.parse_stream(payload)
    assert parse_stream(payload) == ([{"a": 1}, {"b": [2, 3]}], True)
    assert not parse_stream(tgw.format_event({"a": 1}))[1]


# ===================================================================== broker
class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def broker_script(pkg):
    """One script over a broker of ``pkg``: a bounded queue overrun, rate
    windows sliding, aging against fresh high priority, deadline slack,
    completions feeding Retry-After, cancels. Returns what it observed and
    the ledger."""
    clk = FakeClock()
    br = pkg.RequestBroker(max_queue=5, rate_limit=3, rate_window_s=1.0,
                           aging_s=1.0, clock=clk)
    seen = []

    def chat(priority=0.0, deadline_s=None, max_tokens=4, client=None):
        return pkg.ChatRequest(model=MODEL, prompt_tokens=[1, 2, 3],
                               max_tokens=max_tokens, priority=priority,
                               deadline_s=deadline_s, client_id=client)

    def submit(**kw):
        try:
            t = br.submit(chat(**kw))
            seen.append(("ok", t.rid))
            return t
        except pkg.QueueFull as e:
            seen.append(("queue_full", round(e.retry_after_s, 9)))
        except pkg.RateLimited as e:
            seen.append(("rate", round(e.retry_after_s, 9)))

    old = submit(client="a")
    for c in ("a", "a", "a", "b", "c", "d"):   # the 4th "a": rate limited
        submit(client=c)
        clk.t += 0.1
    clk.t += 7.0
    fresh = submit(priority=5.0, client="e")   # the queue is full
    seen.append(("pick", br.pick().rid))       # the aged one wins
    seen.append(("slack", br.min_slack_s()))
    urgent = submit(deadline_s=0.2, client="f")
    seen.append(("slack", round(br.min_slack_s(), 9)))
    clk.t += 0.15
    while (t := br.pick()) is not None:
        seen.append(("pick", t.rid))
        clk.t += 0.5
        if t.rid % 2:
            br.complete(t, generated_tokens=4)
        else:
            seen.append(("cancel", br.cancel(t)))
    seen.append(("retry_after", round(br.retry_after_s(), 9)))
    seen.append(("cancel_again", br.cancel(old), old is not None,
                 fresh is None, urgent is not None))
    assert br.reconciles()
    return seen, br.ledger.as_dict(), br.stats()


def test_broker_ledger_equals_the_reference():
    j, t = broker_script(jgw), broker_script(tgw)
    assert t == j
    seen, led, _ = t
    assert led["rejected_429_queue"] >= 1 and led["rejected_429_rate"] >= 1
    assert led["completed"] >= 1 and led["cancelled"] >= 1


def test_bounded_queue_exactly_k_rejections():
    br = RequestBroker(max_queue=5, clock=FakeClock())
    rejected = 0
    for _ in range(5 + 3):
        try:
            br.submit(tgw.ChatRequest(model=MODEL, prompt_tokens=[1],
                                      max_tokens=4))
        except QueueFull as e:
            rejected += 1
            assert e.retry_after_s >= 1.0
    assert rejected == 3 and br.depth() == 5 and br.reconciles()
    with pytest.raises(RateLimited):
        rl = RequestBroker(max_queue=8, rate_limit=1, clock=FakeClock())
        for _ in range(2):
            rl.submit(tgw.ChatRequest(model=MODEL, prompt_tokens=[1],
                                      max_tokens=4, client_id="x"))


# ============================================================ tier picks
def synth(plan, tier_entry, schedule):
    return schedule(tiers={1: tier_entry(plan("static", []), 1.0),
                           8: tier_entry(plan("static", []), 2.0)},
                    pinned_bytes=0, scratch_bytes=0, budget_bytes=0)


def test_tier_picks_with_queue_hints_equal_the_reference(planned):
    picks = []
    for s in (synth(JPlan, JTierEntry, JSchedule),
              synth(Plan, TierEntry, Schedule),
              planned["jsched"], planned["tsched"]):
        picks.append([s.pick_decode_tier(n, queue_depth=q, slack_s=sl)
                      for n in (1, 2, 3) for q in (0, 1, 3, 7, 16)
                      for sl in (None, 0.001, 1.5, 3.0)]
                     + [s.pick_prefill_tier(n, min_tier=m, queue_depth=q)
                        for n in (1, 4, 12) for m in (1, 2)
                        for q in (0, 3, 16)])
    assert picks[0] == picks[1] and picks[2] == picks[3]
    s = synth(Plan, TierEntry, Schedule)
    assert s.pick_decode_tier(1) == s.pick_tier(1) == 1
    assert s.pick_decode_tier(1, queue_depth=7) == 8
    assert s.pick_decode_tier(1, queue_depth=7, slack_s=1.5) == 1
    assert s.pick_prefill_tier(1, min_tier=1, queue_depth=3) == 8


# ============================================================ model fixtures
@pytest.fixture(scope="module")
def planned():
    """Both packages' yi-9b smoke in f32, the same weights, and their
    schedules at 0.2x."""
    jdb, tdb = jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)
    jcfg = jax_smoke("yi-9b").replace(dtype="float32")
    tcfg = torch_smoke("yi-9b").replace(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    total = sum(s.weight_bytes for s in build_graph(tcfg, wdtype=2))
    budget = int(total * 0.2) + 1
    js = repro.Session.open(jcfg, JCLI2, budget, JSetting(**SETTING),
                            db=jdb, params=jp, max_seq=64)
    tsched = build_schedule(budget, build_graph(tcfg, wdtype=2),
                            TimingEstimator(tdb, CLI2),
                            InferenceSetting(**SETTING))
    return dict(jcfg=jcfg, cfg=tcfg, jp=jp, params=tp, jsched=js.schedule,
                tsched=tsched, db=tdb, total=total)


def make_batcher(p, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    return ContinuousBatcher(p["cfg"], p["params"], p["tsched"],
                             device="cpu", **kw)


def session(p, frac=0.2, **kw):
    return Session.open(p["cfg"], CLI2, int(p["total"] * frac) + 1,
                        InferenceSetting(**SETTING), db=p["db"],
                        params=p["params"], max_seq=64, device="cpu", **kw)


def wave(cls, vocab, n=4, max_new=4):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=5 + 2 * i)
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def body_for(cfg, token_ids, max_tokens=4, **kw):
    return json.dumps({"model": cfg.name, "token_ids": token_ids,
                       "max_tokens": max_tokens, **kw}).encode()


# ============================================================ incremental
def test_ttft_none_until_first_token_and_stats_skip(planned):
    r = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=4)
    assert r.ttft is None
    b = make_batcher(planned)
    reqs = wave(Request, planned["cfg"].vocab)
    b.submit(reqs)
    b.step()
    started = [r for r in reqs if r.ttft is not None]
    assert started and len(started) < len(reqs)
    assert all(r.ttft > 0 for r in started)
    assert b.stats()["mean_ttft_s"] >= 0.0
    b.serve([])
    assert b.stats()["mean_ttft_s"] == pytest.approx(
        float(np.mean([r.ttft for r in reqs])))


def test_step_matches_serve_and_events_cover_tokens(planned):
    ref = wave(JRequest, planned["cfg"].vocab)
    JBatcher(planned["jcfg"], planned["jp"], planned["jsched"], max_batch=2,
             max_seq=64).serve(ref)
    direct = wave(Request, planned["cfg"].vocab)
    make_batcher(planned).serve(direct)
    b = make_batcher(planned)
    reqs = wave(Request, planned["cfg"].vocab)
    b.submit(reqs)
    events = []
    while b.has_work:
        events.append(b.step())
    assert [r.generated for r in reqs] == [r.generated for r in direct] \
        == [r.generated for r in ref]
    per_rid = {}
    for ev in (e for it in events for e in it):
        per_rid.setdefault(ev.rid, []).append(ev)
    for r in reqs:
        evs = per_rid[r.rid]
        assert [e.token for e in evs] == r.generated
        assert [e.index for e in evs] == list(range(len(r.generated)))
        assert [e.done for e in evs] == \
            [i == len(evs) - 1 for i in range(len(evs))]
        assert all(e.error is None for e in evs)
    assert not b.step()


def test_cancel_frees_slot_and_leaves_others_bit_identical(planned):
    ref = wave(Request, planned["cfg"].vocab, max_new=6)
    make_batcher(planned).serve(ref)
    b = make_batcher(planned)
    reqs = wave(Request, planned["cfg"].vocab, max_new=6)
    b.submit(reqs)
    b.step()
    assert b.cancel(0) == "active" and b.cancel(2) == "queued"
    assert b.cancel(99) is None
    b.serve([])
    assert reqs[0].cancelled_at is not None and len(reqs[0].generated) <= 2
    for i in (1, 3):
        assert reqs[i].generated == ref[i].generated
    st = b.stats()
    assert st["cancelled"] == 2 and st["completed"] == 2


def test_queue_pressure_hints_reach_the_executor(planned):
    b = make_batcher(planned)
    b.submit(wave(Request, planned["cfg"].vocab, n=1))
    b.set_queue_pressure(5, slack_s=0.5)
    b.step()
    # one active slot, imminent batch capped at max_batch 2
    assert b.ex.sched_queue_depth == 1 and b.ex.sched_slack_s == 0.5
    assert b.stats()["failed"] == 0 and b.stats()["degradations"] == 0


# ============================================================ gateway http
def test_gateway_http_error_paths(planned):
    cfg = planned["cfg"]

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=4)
        c = InprocClient(gw)
        for body, status, code in (
                (b"{nope", 400, "invalid_json"),
                (json.dumps({"model": "gpt-oops", "token_ids": [1]})
                 .encode(), 404, "model_not_found"),
                (body_for(cfg, [1] * 60, max_tokens=8), 413,
                 "context_window_exceeded")):
            st, _, b = await c.request("POST", "/v1/chat/completions", body)
            assert st == status and json.loads(b)["error"]["code"] == code
        st, _, b = await c.request("GET", "/nope")
        assert st == 404 and json.loads(b)["error"]["code"] == "unknown_route"
        st, _, b = await c.request("POST", "/v1/chat/completions", b"",
                                   headers={"content-length": str(2 << 20)})
        assert st == 413 and json.loads(b)["error"]["code"] \
            == "body_too_large"
        st, _, b = await c.request("GET", "/v1/models")
        assert st == 200 and json.loads(b)["data"][0]["id"] == cfg.name
        st, _, b = await c.request("GET", "/healthz")
        assert st == 200 and json.loads(b)["status"] == "ok"
        await gw.close()

    run(main())


async def stream_wave(gw, c, cfg, reqs):
    """Staggered streamed requests through ``gw``: tokens per rid."""
    async def client(r, out):
        st, _, end = await c.open_stream(
            "POST", "/v1/chat/completions",
            body_for(cfg, [int(t) for t in r.prompt],
                     max_tokens=r.max_new_tokens, stream=True))
        assert st == 200
        raw = await end.reader.read()
        end.close()
        chunks, done = parse_stream(raw)
        assert done
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        out[r.rid] = [ch["choices"][0]["delta"]["token_id"] for ch in chunks]

    out, tasks = {}, []
    for r in reqs:
        tasks.append(asyncio.ensure_future(client(r, out)))
        await asyncio.sleep(0.01)
    await asyncio.gather(*tasks)
    return out


@pytest.mark.parametrize("queue_aware", [True, False])
def test_gateway_wave_equals_direct_and_the_reference(planned, queue_aware):
    """The staggered SSE wave: the port's gateway gives the tokens of a
    direct ``serve`` of the same prompts and of the reference's gateway,
    and its first chunk leaves before the first request completes."""
    cfg = planned["cfg"]
    direct = wave(Request, cfg.vocab, n=5)
    make_batcher(planned).serve(direct)

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=16,
                     queue_aware=queue_aware).start()
        out = await stream_wave(gw, InprocClient(gw), cfg,
                                wave(Request, cfg.vocab, n=5))
        assert gw._first_chunk_at < gw._first_done_at
        m = gw.metrics()
        await gw.close()
        jb = JBatcher(planned["jcfg"], planned["jp"], planned["jsched"],
                      max_batch=2, max_seq=64)
        jg = jgw.Gateway(batcher=jb, max_queue=16,
                         queue_aware=queue_aware).start()
        jout = await stream_wave(jg, jgw.InprocClient(jg), cfg,
                                 wave(JRequest, cfg.vocab, n=5))
        jm = jg.metrics()
        await jg.close()
        return out, m, jout, jm

    out, m, jout, jm = run(main())
    for r in direct:
        assert out[r.rid] == r.generated, f"rid {r.rid}"
    assert out == jout

    def ledger(metrics):   # the peak queue depth follows the step times
        return {k: v for k, v in metrics["broker"]["ledger"].items()
                if k != "peak_queue_depth"}

    assert ledger(m) == ledger(jm)
    assert m["broker"]["ledger"]["completed"] == 5 and m["broker"]["reconciles"]
    assert m["ttft_p50_s"] > 0 and m["ttft_p99_s"] >= m["ttft_p50_s"]


def test_gateway_steps_on_one_thread_of_its_own(planned):
    """Every batcher step runs on the gateway's one step thread (each
    thread that runs cuBLAS holds a workspace of its own on the card),
    never on the event loop's thread; ``close`` ends it."""
    import threading
    cfg = planned["cfg"]
    b = make_batcher(planned)
    threads, step = set(), b.step

    def spy():
        threads.add(threading.get_ident())
        return step()

    b.step = spy

    async def main():
        gw = Gateway(batcher=b, max_queue=16).start()
        await stream_wave(gw, InprocClient(gw), cfg,
                          wave(Request, cfg.vocab, n=5))
        pool = gw._step_pool
        await gw.close()
        return pool

    pool = run(main())
    assert len(threads) == 1 and threading.get_ident() not in threads
    assert pool is not None and pool._shutdown


def test_gateway_unary_matches_stream(planned):
    cfg = planned["cfg"]

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=8)
        c = InprocClient(gw)
        st, _, b = await c.request("POST", "/v1/chat/completions",
                                   body_for(cfg, [7, 8, 9]))
        assert st == 200
        obj = json.loads(b)
        ch = obj["choices"][0]
        assert obj["object"] == "chat.completion"
        assert ch["finish_reason"] == "length"
        assert obj["usage"] == {"prompt_tokens": 3, "completion_tokens": 4,
                                "total_tokens": 7}
        st, _, b2 = await c.request("POST", "/v1/chat/completions",
                                    body_for(cfg, [7, 8, 9], stream=True))
        chunks, done = parse_stream(b2)
        assert done
        assert [c2["choices"][0]["delta"]["token_id"] for c2 in chunks] \
            == ch["token_ids"]
        assert encode_text(ch["message"]["content"], cfg.vocab) \
            == ch["token_ids"]
        await gw.close()

    run(main())


def test_gateway_backpressure_exactly_k_429(planned):
    cfg = planned["cfg"]
    Q, K = 4, 3

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=Q)
        gw._wake = asyncio.Event()
        hold = asyncio.ensure_future(asyncio.sleep(3600))
        gw._pump_task = hold          # holds the pump: the queue fills
        c = InprocClient(gw)
        tasks = [asyncio.ensure_future(
            c.request("POST", "/v1/chat/completions",
                      body_for(cfg, [1 + i, 2, 3])))
            for i in range(Q + K)]
        while gw.broker.ledger.received < Q + K:
            await asyncio.sleep(0.001)
        assert gw.broker.depth() == Q and gw.broker.reconciles()
        hold.cancel()
        gw._pump_task = None
        gw.start()
        results = await asyncio.gather(*tasks)
        rejected = [h for st, h, _ in results if st == 429]
        assert len(rejected) == K
        assert all(int(h["retry-after"]) >= 1 for h in rejected)
        assert [st for st, _, _ in results].count(200) == Q
        await gw.close(drain=True)
        led = gw.broker.ledger.as_dict()
        assert led["completed"] == Q and led["rejected_429_queue"] == K
        assert gw.metrics()["broker"]["ledger"] == led

    run(main())


def test_gateway_rate_limit_over_http(planned):
    cfg = planned["cfg"]

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=8,
                     rate_limit=1, rate_window_s=30.0)
        c = InprocClient(gw)
        hdr = {"x-client-id": "hammer"}
        st1, _, _ = await c.request("POST", "/v1/chat/completions",
                                    body_for(cfg, [1, 2]), headers=hdr)
        st2, h2, b2 = await c.request("POST", "/v1/chat/completions",
                                      body_for(cfg, [1, 2]), headers=hdr)
        assert st1 == 200 and st2 == 429 and "retry-after" in h2
        assert json.loads(b2)["error"]["code"] == "rate_limited"
        st3, _, _ = await c.request("POST", "/v1/chat/completions",
                                    body_for(cfg, [1, 2]),
                                    headers={"x-client-id": "gentle"})
        assert st3 == 200
        await gw.close()

    run(main())


def test_gateway_disconnect_cancels_and_frees_paged_kv(planned):
    cfg = planned["cfg"]
    ref = wave(Request, cfg.vocab, n=3, max_new=6)
    bref = make_batcher(planned, kv_layout="paged")
    bref.kv.prefix_enabled = False
    bref.serve(ref)

    async def victim(c, r):
        st, _, end = await c.open_stream(
            "POST", "/v1/chat/completions",
            body_for(cfg, [int(t) for t in r.prompt],
                     max_tokens=r.max_new_tokens, stream=True))
        assert st == 200
        await end.reader.readuntil(b"\n\n")     # one chunk, then vanish
        end.close()

    async def survivor(c, r, out):
        st, _, b = await c.request(
            "POST", "/v1/chat/completions",
            body_for(cfg, [int(t) for t in r.prompt],
                     max_tokens=r.max_new_tokens))
        assert st == 200
        out[r.rid] = json.loads(b)["choices"][0]["token_ids"]

    async def main():
        b = make_batcher(planned, kv_layout="paged")
        b.kv.prefix_enabled = False
        gw = Gateway(batcher=b, max_queue=8).start()
        c = InprocClient(gw)
        reqs = wave(Request, cfg.vocab, n=3, max_new=6)
        out = {}
        tasks = [asyncio.ensure_future(victim(c, reqs[0]))]
        await asyncio.sleep(0)
        tasks += [asyncio.ensure_future(survivor(c, r, out))
                  for r in reqs[1:]]
        await asyncio.gather(*tasks)
        await gw.close(drain=True)
        return b, gw, out

    b, gw, out = run(main())
    for r in ref[1:]:
        assert out[r.rid] == r.generated, f"rid {r.rid} perturbed"
    assert gw.broker.ledger.cancelled == 1
    assert gw.broker.ledger.completed == 2 and gw.broker.reconciles()
    assert all(s is None for s in b.slots)
    b.kv.alloc.check()
    assert len(b.kv.alloc.blocks) == 0, "paged-KV blocks leaked"


def test_gateway_drain_rejects_with_503_and_its_deadline_cancels(planned):
    cfg = planned["cfg"]

    async def main():
        gw = Gateway(batcher=make_batcher(planned), max_queue=8).start()
        c = InprocClient(gw)
        st, _, _ = await c.request("POST", "/v1/chat/completions",
                                   body_for(cfg, [1, 2]))
        assert st == 200
        closer = asyncio.ensure_future(gw.close(drain=True))
        await asyncio.sleep(0)
        st, _, b = await c.request("POST", "/v1/chat/completions",
                                   body_for(cfg, [1, 2]))
        assert st == 503 and json.loads(b)["error"]["code"] \
            == "shutting_down"
        st, _, b = await c.request("GET", "/healthz")
        assert st == 200 and json.loads(b)["draining"]
        await closer

        b = make_batcher(planned)
        gw = Gateway(batcher=b, max_queue=8).start()
        c = InprocClient(gw)
        victim = asyncio.ensure_future(c.request(
            "POST", "/v1/chat/completions",
            body_for(cfg, [1, 2, 3], max_tokens=48)))
        for _ in range(200):
            await asyncio.sleep(0.005)
            if any(sl is not None for sl in b.slots):
                break
        await gw.close(drain=True, drain_deadline_s=0.01)
        st, hdrs, body = await victim
        assert st == 503 and json.loads(body)["error"]["code"] \
            == "shutting_down"
        assert int(hdrs.get("retry-after", "0")) >= 1
        m = gw.metrics()
        assert m["aborted_on_close"] == 1 and m["active_slots"] == 0
        assert m["broker"]["reconciles"] and not b.pending

    run(main())


def test_gateway_rebudget_over_http(planned):
    cfg = planned["cfg"]
    sess = session(planned)
    ref = wave(Request, cfg.vocab, n=3, max_new=6)
    make_batcher(planned).serve(ref)

    async def main():
        gw = sess.gateway(max_queue=8, max_batch=2).start()
        c = InprocClient(gw)
        st, _, b = await InprocClient(Gateway(
            batcher=make_batcher(planned))).request(
            "POST", "/admin/rebudget", json.dumps({"budget_bytes": 1})
            .encode())
        assert st == 409 and json.loads(b)["error"]["code"] == "no_session"
        st, _, b = await c.request("POST", "/admin/rebudget", b"{}")
        assert st == 400
        out = {}

        async def go(r):
            st, _, body = await c.request(
                "POST", "/v1/chat/completions",
                body_for(cfg, [int(t) for t in r.prompt],
                         max_tokens=r.max_new_tokens))
            assert st == 200
            out[r.rid] = json.loads(body)["choices"][0]["token_ids"]

        tasks = [asyncio.ensure_future(go(r))
                 for r in wave(Request, cfg.vocab, n=3, max_new=6)]
        await asyncio.sleep(0)
        new = int(planned["total"] * 0.5) + 1
        st, _, b = await c.request(
            "POST", "/admin/rebudget",
            json.dumps({"budget_bytes": new}).encode())
        assert st == 200
        obj = json.loads(b)
        assert obj["applied"] and obj["budget_bytes"] == new
        diff = sess.replan_log[-1]
        assert obj["moved_bytes"] == diff.moved_bytes
        await asyncio.gather(*tasks)
        await gw.close(drain=True)
        return out

    out = run(main())
    for r in ref:
        assert out[r.rid] == r.generated, f"rid {r.rid}"


def test_gateway_metrics_expose_spec_counters(planned):
    cfg = planned["cfg"]
    sess = session(planned, 1.8, draft_cfg=cfg, draft_params=planned["params"],
                   spec_k=3)
    assert sess.spec_active

    async def main():
        gw = sess.gateway(max_queue=8, max_batch=2).start()
        c = InprocClient(gw)

        async def go(r):
            st, _, body = await c.request(
                "POST", "/v1/chat/completions",
                body_for(cfg, [int(t) for t in r.prompt],
                         max_tokens=r.max_new_tokens))
            assert st == 200
            return json.loads(body)["choices"][0]["token_ids"]

        out = await asyncio.gather(*[go(r) for r in wave(
            Request, cfg.vocab, n=3, max_new=6)])
        st, _, b = await c.request("GET", "/metrics")
        await gw.close(drain=True)
        return json.loads(b), out

    m, out = run(main())
    assert all(len(t) == 6 for t in out)
    srv, direct = m["serving"], sess._batcher.stats()
    for k in ("spec_k", "spec_drafted", "spec_accepted", "accept_rate",
              "spec_rollbacks", "spec_rolled_back_tokens",
              "spec_verify_passes"):
        assert srv[k] == direct[k], k
    assert srv["spec_k"] == 3 and srv["spec_verify_passes"] > 0
    assert srv["spec_drafted"] == \
        srv["spec_accepted"] + srv["spec_rolled_back_tokens"]
    assert srv["draft"]["streamed_bytes"] == 0
    assert m["broker"]["reconciles"]
    assert m["broker"]["ledger"]["completed"] == len(out)


# ============================================================ faults
def test_gateway_request_fault_isolated(planned):
    """A ``serving.request`` fault answers 500 to its client alone; the
    others' tokens are undisturbed, the pump lives on, and the ledger
    reconciles with one failed ticket."""
    cfg = planned["cfg"]
    ref = wave(Request, cfg.vocab, n=3, max_new=5)
    make_batcher(planned).serve(ref)
    sess = session(planned, faults=FaultPlan(
        [FaultSpec("serving.request", "fail", key="2", after=1)]),
        recovery=FAST)

    async def main():
        gw = sess.gateway(max_queue=8, max_batch=2).start()
        c = InprocClient(gw)
        out = {}

        async def go(i, r):
            st, _, body = await c.request(
                "POST", "/v1/chat/completions",
                body_for(cfg, [int(t) for t in r.prompt],
                         max_tokens=r.max_new_tokens))
            out[i] = (st, json.loads(body))

        tasks = []
        for i, r in enumerate(ref):
            tasks.append(asyncio.ensure_future(go(i, r)))
            await asyncio.sleep(0)   # broker rids 1, 2, 3 in this order
        await asyncio.gather(*tasks)
        st, _, _ = await c.request("POST", "/v1/chat/completions",
                                   body_for(cfg, [int(t) for t in
                                                  ref[0].prompt]))
        assert st == 200
        m = await c.request("GET", "/metrics")
        await gw.close(drain=True)
        return out, json.loads(m[2])

    out, m = run(main())
    assert out[1][0] == 500
    assert out[1][1]["error"]["code"] == "internal_error"
    for i in (0, 2):
        assert out[i][0] == 200
        assert out[i][1]["choices"][0]["token_ids"] == ref[i].generated
    assert m["broker"]["ledger"]["failed"] == 1 and m["broker"]["reconciles"]
    assert m["serving"]["failed"] == 1
    assert m["degradation"]["injected"]["fired_total"] == 1


def test_gateway_pump_fault_fails_its_turn_only(planned):
    """A ``gateway.pump`` fault fails the tickets of that turn with 500;
    the pump survives and a later request completes."""
    cfg = planned["cfg"]
    sess = session(planned, faults=FaultPlan(
        [FaultSpec("gateway.pump", "fail", count=1)]), recovery=FAST)

    async def main():
        gw = sess.gateway(max_queue=8, max_batch=2).start()
        c = InprocClient(gw)
        st1, _, b1 = await c.request("POST", "/v1/chat/completions",
                                     body_for(cfg, [1, 2, 3]))
        st2, _, _ = await c.request("POST", "/v1/chat/completions",
                                    body_for(cfg, [1, 2, 3]))
        st, _, h = await c.request("GET", "/healthz")
        m = await c.request("GET", "/metrics")
        await gw.close(drain=True)
        return st1, json.loads(b1), st2, json.loads(h), json.loads(m[2])

    st1, b1, st2, health, m = run(main())
    assert st1 == 500 and b1["error"]["code"] == "internal_error"
    assert st2 == 200
    assert health["pump_errors"] == 1 and m["pump_errors"] == 1
    assert m["broker"]["ledger"]["failed"] == 1 and m["broker"]["reconciles"]


def test_healthz_reports_the_degradation(planned):
    sess = session(planned)
    sess.degrade(reason="test")

    async def main():
        gw = sess.gateway(max_queue=4, max_batch=2).start()
        st, _, body = await InprocClient(gw).request("GET", "/healthz")
        m = gw.metrics()
        await gw.close(drain=False)
        return st, json.loads(body), m

    st, health, m = run(main())
    assert st == 200 and health["status"] == "degraded"
    assert health["degradation_level"] == DEGRADATION_RUNGS.index(
        "tier_down")
    assert health["degradation_rung"] == "tier_down"
    assert m["degradation"] == sess.degradation()
