"""The check fails a broken timed path. Each test drives the rest of a
run on the CPU (the harness's look for a card skipped) at smoke size,
with the port broken underneath, and sees ``correct`` come out false; a
sound run comes out true. A one-card serving cell can have three of the
faults: a step that leaves its state unchanged (decode writes no KV), a
part of the batch left out (half the active slots masked out of the
pass), and a token altered where it is produced. It has no exchange
between cards."""
import pytest
import torch

from portbench.harness import run_cell

SEED = 2 ** 32 + 77


CELLS = ["tiny-dense.tiny", "tiny-moe.tiny"]


def _run(tiny_bench, cell, **kw):
    """One tiny run on one CPU thread: under a loaded host, threads that
    spin against other processes' can stall a short window until it
    finishes barely a request."""
    root, bench = tiny_bench
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(root, cell, SEED, 5.0, device="cpu",
                                  bench_dir=bench, log=lambda *a: None, **kw)
    finally:
        torch.set_num_threads(threads)
    return result, {c[0]: c for c in checks}


def _failed_on_gap(result, checks):
    """``correct`` false, and by the gap the cell limits."""
    assert not result["correct"]
    gap = [c for k, c in checks.items() if k.endswith("_logit_gap")]
    assert gap and all(c[1] > c[2] for c in gap)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_bench, cell):
    result, checks = _run(tiny_bench, cell)
    assert result["correct"], checks
    assert checks["compared_tokens"][1] > 0
    assert checks["off_dtype_weight_bytes"][1] == 0
    # the closed loop cycled: a client sent again after a request finished
    assert result["attempted"] > 3 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_fails(tiny_bench, monkeypatch, cell):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "cache_update_batched",
                        lambda ck, cv, k, v, pos, active=None: (ck, cv))
    _failed_on_gap(*_run(tiny_bench, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_fails(tiny_bench, monkeypatch, cell):
    from repro_torch.core.serving import ContinuousBatcher
    real = ContinuousBatcher._device_inputs

    def half(self, pos_vec, mask):
        mask = mask.copy()
        on = [i for i in range(len(mask)) if mask[i]]
        for i in on[len(on) // 2:]:
            mask[i] = False
        return real(self, pos_vec, mask)
    monkeypatch.setattr(ContinuousBatcher, "_device_inputs", half)
    _failed_on_gap(*_run(tiny_bench, cell))


def test_window_with_nothing_finished_is_not_correct(tiny_bench, monkeypatch):
    """A window that finishes no request has nothing to compare: the run
    reports, and comes out not correct."""
    from portbench import harness
    real = harness.serve_window

    def unfinished(*args, **kw):
        sent, steps, w0, end, last = real(*args, **kw)
        for r in sent.values():
            r.done_ns = None
        return sent, steps, w0, end, last
    monkeypatch.setattr(harness, "serve_window", unfinished)
    result, checks = _run(tiny_bench, "tiny-dense.tiny")
    assert not result["correct"]
    assert checks["compared_tokens"][1] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_fails(tiny_bench, monkeypatch, cell):
    from repro_torch.core import serving

    def off_by_one(logits):
        tok = torch.argmax(logits.to(torch.float32), dim=-1)
        return ((tok + 1) % logits.shape[-1]).to(torch.int32)
    monkeypatch.setattr(serving, "greedy_token", off_by_one)
    _failed_on_gap(*_run(tiny_bench, cell))


def test_int8_control_fails(tiny_bench, monkeypatch):
    """The check's control is the program with its own int8 path on: the
    session is opened with ``weight_quant="int8"`` and int8 FFN weights
    (kernel K2's storage). Its served tokens go to the same reference,
    and the run comes out not correct by the weights it served in
    another dtype than the configuration states."""
    from repro_torch import Session
    seen = []
    real = Session.open.__func__

    def spy(cls, cfg, *args, **kw):
        seen.append((cfg.weight_quant,
                     kw["params"]["layers"]["ffn"]["w_up"].dtype))
        return real(cls, cfg, *args, **kw)
    monkeypatch.setattr(Session, "open", classmethod(spy))
    result, c = _run(tiny_bench, "tiny-dense.tiny", weight_quant="int8")
    assert seen == [("int8", torch.int8)]
    assert c["compared_tokens"][1] > 0 and result["attempted"] > 3
    assert not result["correct"]
    # the three FFN matrices of both layers, one byte a weight
    assert c["off_dtype_weight_bytes"][1] == 2 * 3 * 64 * 128
