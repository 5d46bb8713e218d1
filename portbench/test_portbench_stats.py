"""The end-to-end readers take every request and the whole window: a
stall planted in the stamps moves the tail of the token gaps and the
token rate, and tokens after the window's end do not count."""
import numpy as np
import pytest

from portbench.harness import Run, Sent, Step
from portbench.spec import metric_reader

MS = 1_000_000


def _run(stall_every=0, seconds=2.0):
    """Four clients served by shared steps of 25 ms; with ``stall_every``
    every such step takes 300 ms instead (a prefill that holds up every
    client). Each request gets 20 tokens, one at each step end after it
    was sent."""
    ends, t, i = [], 0, 0
    while t < (seconds + 5) * 1000 * MS:
        t += (300 if stall_every and i % stall_every == stall_every - 1
              else 25) * MS
        ends.append(t)
        i += 1
    reqs, rid = [], 0
    for c in range(4):
        k = c   # clients start one step apart
        send = 0
        while k + 20 < len(ends) and send < seconds * 1000 * MS:
            r = Sent(rid, prompt=[0] * 300, max_new=20, send_ns=send)
            r.token_ns = ends[k:k + 20]
            r.done_ns = r.token_ns[-1]
            reqs.append(r)
            send, k, rid = r.done_ns, k + 20, rid + 1
    end = int(seconds * 1000 * MS)
    steps = [Step(a, b, 0, 0, 4, 1) for a, b in zip([0] + ends, ends)
             if b <= end]
    return Run(seconds=seconds, w0_ns=0, end_ns=end, last_ns=steps[-1].t1_ns,
               setup_s=12.5, requests=reqs, steps=steps, counters={},
               trace=None, k1_calls=[])


def read(name, run):
    return metric_reader(name)(run)


def test_window_rate_counts_only_tokens_in_the_window():
    run = _run()
    inside = sum(sum(1 for t in r.token_ns if t <= run.end_ns)
                 for r in run.requests)
    total = sum(len(r.token_ns) for r in run.requests)
    assert inside < total
    assert read("out_tok_s", run) == pytest.approx(inside / 2.0)


def test_planted_stall_moves_the_gap_tail_and_the_rate():
    calm, stalled = _run(), _run(stall_every=8)
    assert read("itl_p95_ms", calm) == pytest.approx(25.0)
    # one step in eight stalls: 1/8 of all gaps are 300 ms, so the p95 of
    # the pooled gaps is the stall, and fewer tokens arrive in the window
    assert read("itl_p95_ms", stalled) == pytest.approx(300.0)
    assert read("out_tok_s", stalled) < 0.5 * read("out_tok_s", calm)


def test_ttft_is_over_every_request_with_a_first_token():
    run = _run()
    ttfts = sorted((r.token_ns[0] - r.send_ns) / 1e9 for r in run.requests
                   if r.token_ns[0] <= run.end_ns)
    assert read("ttft_p50_s", run) == pytest.approx(
        float(np.median(ttfts)))
    early = [r for r in run.requests if r.send_ns < 1050 * MS]
    for r in early:
        r.token_ns[0] = r.send_ns + 900 * MS   # slow first tokens
    slow = [(r.token_ns[0] - r.send_ns) / 1e9 for r in run.requests
            if r.token_ns[0] <= run.end_ns]
    assert len(slow) == len(ttfts)
    assert read("ttft_p50_s", run) == pytest.approx(float(np.median(slow)))
    assert read("ttft_p50_s", run) > float(np.median(ttfts))
    assert read("setup_s", run) == 12.5
