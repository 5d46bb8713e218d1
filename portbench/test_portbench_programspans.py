"""The readers of the program's spans (``programspans.py`` and the five
``program_span`` metrics that split the serve loop) on synthetic spans
with known sums; each returns None with no spans, with none in the
window, and with no tracer module (the parent commit's program)."""
import sys
from types import SimpleNamespace

import pytest

from portbench import spec
from repro_torch.core import trace

MAIN, WORKER = 1, 2
READERS = ("decode_dispatch_ms", "decode_weight_wait_ms",
           "decode_device_wait_ms", "h2d_copy_ms_per_step",
           "admit_weight_wait_ms_per_ktok")


def _span(id, name, t0, t1, parent=None, thread=MAIN, **attrs):
    s = trace.Span(id, name, t0, parent, thread, None)
    s.t1_ns = t1
    s.attrs = attrs
    return s


# two decode passes of 10,000 and 6,000 ns, two admissions of 500 and 250
# prompt tokens, and a decode pass after the window (ns)
SPANS = [
    _span(1, "serve.decode", 1000, 11000),
    _span(2, "sub.attn", 1100, 5000, 1),
    _span(3, "wait.weights", 1200, 3200, 2, how="at_use"),
    _span(4, "copy.h2d", 1300, 3000, 3, pool="at_use", device_ns=1500),
    _span(5, "wait.device", 9000, 10000, 1, what="tokens"),
    _span(6, "serve.decode", 20000, 26000),
    _span(7, "sub.ffn", 20100, 25000, 6),
    _span(8, "wait.weights", 20200, 21200, 7, how="streamed"),
    # nested in a wait: counted with it, not again
    _span(9, "wait.device", 20300, 20400, 8, what="pages"),
    _span(10, "wait.device", 25000, 25500, 6, what="tokens"),
    # the worker's copies: one starts in the second pass, one between
    _span(11, "copy.h2d", 20050, 21000, thread=WORKER, pool="static",
          device_ns=4000),
    _span(12, "copy.h2d", 15000, 16000, thread=WORKER, pool="static",
          device_ns=9999),
    _span(18, "prefetch.slot_wait", 19000, 20040, thread=WORKER),
    _span(13, "serve.admit", 30000, 40000, prompt_tokens=500),
    _span(15, "sub.attn", 30100, 35000, 13),
    _span(14, "wait.weights", 30200, 33200, 15, how="streamed"),
    _span(16, "serve.admit", 41000, 45000, prompt_tokens=250),
    _span(17, "serve.decode", 100000, 200000),
    _span(19, "wait.weights", 100100, 199000, 17, how="streamed"),
]
RUN = SimpleNamespace(w0_ns=0, last_ns=50000)
EXPECTED = {
    # (16,000 - 3,000 waited for weights - 1,500 for the device) / 2
    "decode_dispatch_ms": 5750e-6,
    "decode_weight_wait_ms": 1500e-6,
    "decode_device_wait_ms": 750e-6,
    # copies 4 and 11, of 1,500 and 4,000 ns on the card, over 2 passes
    "h2d_copy_ms_per_step": 2750e-6,
    # 3,000 ns over 0.75 ktok
    "admit_weight_wait_ms_per_ktok": 4000e-6,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_sums(name, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    assert spec.metric_reader(name)(RUN) == pytest.approx(EXPECTED[name],
                                                          rel=1e-12)


def test_decode_parts_add_up_to_the_mean_decode_span(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    parts = sum(spec.metric_reader(n)(RUN) for n in READERS[:3])
    assert parts == pytest.approx((10000 + 6000) / 2 / 1e6, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_spans(name, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert spec.metric_reader(name)(RUN) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_outside_the_window(name, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    assert spec.metric_reader(name)(
        SimpleNamespace(w0_ns=300000, last_ns=400000)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_the_tracer(name, monkeypatch):
    import repro_torch.core
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert spec.metric_reader(name)(RUN) is None


def test_copies_without_device_time_read_none(monkeypatch):
    """A CPU run's copies carry no ``device_ns``."""
    untimed = [s for s in SPANS if s.name != "copy.h2d"] + [
        _span(20, "copy.h2d", 1300, 3000, 3, pool="at_use")]
    monkeypatch.setattr(trace, "spans", lambda: untimed)
    assert spec.metric_reader("h2d_copy_ms_per_step")(RUN) is None
    assert spec.metric_reader("decode_weight_wait_ms")(RUN) == \
        pytest.approx(EXPECTED["decode_weight_wait_ms"])
