"""The port's planner against the JAX package's, field for field.

Graph, profile DB, schedule and timing estimates are pure Python in both
packages, so the port's copies must agree exactly: same sub-layer names and
bytes, same placements and tier table, same scratch and KV-pool sizing,
same estimated times. Checked on the analytic install profile (the one a
non-local system gets) at budgets of 2.0x, 0.5x and 0.1x of the weights, on
a paper client (cli2) and on the port's h100 system, for the smoke configs
and for qwen2-0.5b at full width.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.core import graphing as jgraph
from repro.core import install as jinstall
from repro.core import planner as jplanner
from repro.core.costmodel import TimingEstimator as JEstimator
from repro.core.system import InferenceSetting as JSetting
from repro.core.system import SystemConfig as JSystem
from repro_torch import configs as tconfigs
from repro_torch.core import SYSTEMS
from repro_torch.core import graphing as tgraph
from repro_torch.core import install as tinstall
from repro_torch.core import planner as tplanner
from repro_torch.core.costmodel import TimingEstimator as TEstimator
from repro_torch.core.system import InferenceSetting as TSetting

BUDGETS = (2.0, 0.5, 0.1)
CASES = [("cli2", "qwen2-0.5b", True), ("cli2", "qwen3-14b", True),
         ("h100", "qwen2-0.5b", True), ("h100", "qwen2-0.5b", False)]


def _plain(obj):
    """A dataclass tree as plain dicts/lists, comparable across packages."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _cfgs(arch, smoke):
    if smoke:
        return jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


@pytest.fixture(scope="module")
def dbs():
    """One analytic ProfileDB per system from each package's install."""
    out = {}
    for name in ("cli2", "h100"):
        tsys = SYSTEMS[name]
        jsys = JSystem(**dataclasses.asdict(tsys))
        out[name] = (jsys, jinstall.run_install(jsys, measure_cpu=False),
                     tsys, tinstall.run_install(tsys, measure_cpu=False))
    return out


@pytest.mark.parametrize("system", ["cli2", "h100"])
def test_install_profile_db_equal(dbs, system):
    _, jdb, _, tdb = dbs[system]
    assert jdb.meta == tdb.meta
    assert _plain(jdb.entries) == _plain(tdb.entries)


def test_measured_install_has_the_reference_schema(monkeypatch):
    """The CPU sweep the port times with torch fills the same ProfileDB
    keys and dims as the reference's jitted sweep (the times differ), at
    small sweep shapes."""
    small = dict(MATMUL_SWEEP=[(1, 64, 64), (8, 64, 128), (16, 128, 64)],
                 ATTN_SWEEP=[(1, 64, 4, 2, 16), (8, 32, 4, 2, 16)],
                 MOE_SWEEP=[(4, 8), (8, 16)],
                 ELTWISE_SWEEP=[(16, 32)])
    for mod in (jinstall, tinstall):
        for name, value in small.items():
            monkeypatch.setattr(mod, name, value)
    local = SYSTEMS["local"]
    jdb = jinstall.run_install(JSystem(**dataclasses.asdict(local)))
    tdb = tinstall.run_install(local)
    assert set(jdb.meta) == set(tdb.meta) >= {"cpu_calibration_scale"}
    assert {k: [e.dims for e in v] for k, v in jdb.entries.items()} == \
        {k: [e.dims for e in v] for k, v in tdb.entries.items()}
    assert all(e.gflops > 0 and e.gbps > 0
               for v in tdb.entries.values() for e in v)


def test_h100_system_is_the_data_sheet_card():
    h = SYSTEMS["h100"]
    assert (h.gpu_tflops, h.gpu_hbm_gbps, h.vram_gb) == (989.0, 3350.0, 80.0)
    assert h.with_(link_gbps=42.0).link_gbps == 42.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-14b", "yi-9b"])
def test_build_graph_equal(arch):
    jcfg, tcfg = _cfgs(arch, smoke=True)
    for wdtype in (2, 1):
        assert _plain(jgraph.build_graph(jcfg, wdtype=wdtype)) == \
            _plain(tgraph.build_graph(tcfg, wdtype=wdtype))
    jfull, tfull = _cfgs("qwen2-0.5b", smoke=False)
    assert _plain(jgraph.build_graph(jfull)) == \
        _plain(tgraph.build_graph(tfull))


@pytest.mark.parametrize("system,arch,smoke", CASES)
def test_schedule_and_estimates_equal(dbs, system, arch, smoke):
    jsys, jdb, tsys, tdb = dbs[system]
    jcfg, tcfg = _cfgs(arch, smoke)
    jsubs, tsubs = jgraph.build_graph(jcfg), tgraph.build_graph(tcfg)
    total = tgraph.total_weight_bytes(tsubs)
    assert total == jgraph.total_weight_bytes(jsubs)
    j_est, t_est = JEstimator(jdb, jsys), TEstimator(tdb, tsys)
    jset, tset = JSetting(batch=4, context=256), TSetting(batch=4,
                                                           context=256)
    for frac in BUDGETS:
        budget = int(total * frac)
        js = jplanner.build_schedule(budget, jsubs, j_est, jset)
        ts = tplanner.build_schedule(budget, tsubs, t_est, tset)
        assert _plain(ts) == _plain(js), f"schedule differs at {frac}x"
        for t in ts.tiers:
            te, je = ts.tiers[t], js.tiers[t]
            assert [p.short() for p in te.plan.placements] == \
                [p.short() for p in je.plan.placements]
            assert (te.scratch_bytes, te.act_bytes, te.est_time,
                    te.prefill_chunk_s) == (je.scratch_bytes, je.act_bytes,
                                            je.est_time, je.prefill_chunk_s)
        assert (ts.pinned_bytes, ts.scratch_bytes, ts.kv_pool_bytes) == \
            (js.pinned_bytes, js.scratch_bytes, js.kv_pool_bytes)
        assert [p.sub.name for p in ts.pinned_placements()] == \
            [p.sub.name for p in js.pinned_placements()]
        for isl in (1, 64, 200):
            for mode in ("layer_major", "chunk_major"):
                assert tplanner.estimate_ttft(ts, isl, mode=mode) == \
                    jplanner.estimate_ttft(js, isl, mode=mode)
        for b in (1, 2, 4):
            assert tplanner.estimate_tps(ts, b) == \
                jplanner.estimate_tps(js, b)
            assert ts.pick_decode_tier(b) == js.pick_decode_tier(b)
            assert ts.pick_prefill_tier(64 * b, min_tier=b) == \
                js.pick_prefill_tier(64 * b, min_tier=b)
        # the live re-plan delta between two budgets
        if frac != BUDGETS[0]:
            jprev = jplanner.build_schedule(int(total * BUDGETS[0]), jsubs,
                                            j_est, jset)
            tprev = tplanner.build_schedule(int(total * BUDGETS[0]), tsubs,
                                            t_est, tset)
            assert _plain(tprev.diff(ts)) == _plain(jprev.diff(js))


def test_streaming_happens_at_the_chip_budget(dbs):
    """At 0.1x on the h100 figures the full-width qwen2-0.5b plan streams
    weights at the decode tier the served batch of 4 picks."""
    _, _, tsys, tdb = dbs["h100"]
    _, tcfg = _cfgs("qwen2-0.5b", smoke=False)
    subs = tgraph.build_graph(tcfg)
    est = TEstimator(tdb, tsys.with_(link_gbps=45.0))
    s = tplanner.build_schedule(int(tgraph.total_weight_bytes(subs) * 0.1),
                                subs, est, TSetting(batch=4, context=256))
    plan = s.tiers[s.pick_decode_tier(4)].plan
    assert plan.streamed_weight_bytes() > 0
    assert {p.sub.kind for p in plan.static_stream_order()} <= {"attn",
                                                                "ffn"}
