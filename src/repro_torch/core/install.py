"""Install-phase benchmarking (paper Step 1).

CPU engine: *measured* on the host with torch kernels — matmul, GQA/MHA,
MoE routing, element-wise — across a dim sweep, single-threaded, with
thread counts above one extrapolated by a measured-shape efficiency curve.
``measure_cpu=None`` measures natively only for the 'local' system; every
other system gets analytic CPU entries, exactly as in the reference, so
``measure_cpu=False`` gives a ProfileDB equal to the reference's.

GPU engine: seeded analytically from SystemConfig data-sheet constants with
an arithmetic-intensity-based efficiency model. Timing the GPU sweeps on the
card with CUDA events is a later change of the port.

PCIe-contention entries (pcie_active=True) carry the bandwidth split the
paper measures on the memory controller.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch.core.profile_db import ProfileDB
from repro_torch.core.system import SystemConfig

MATMUL_SWEEP = [
    (1, 512, 512), (1, 2048, 2048), (1, 8192, 2048), (4, 2048, 2048),
    (16, 2048, 2048), (64, 2048, 2048), (256, 2048, 2048), (1024, 2048, 2048),
    (4096, 2048, 2048), (256, 8192, 2048), (1024, 8192, 8192),
]
ATTN_SWEEP = [  # (t, ctx, H, KV, hd)
    (1, 1024, 32, 8, 128), (1, 4096, 32, 8, 128), (1, 16384, 32, 8, 128),
    (64, 4096, 32, 8, 128), (1024, 1024, 32, 8, 128), (1024, 4096, 32, 8, 128),
]
MOE_SWEEP = [(16, 64), (256, 128), (4096, 128)]
ELTWISE_SWEEP = [(1024, 2048), (16384, 4096)]

THREAD_COUNTS = (1, 2, 4, 8, 16)
# measured many-core scaling on client parts is sub-linear; amdahl-ish curve
THREAD_EFF = {1: 1.0, 2: 1.9, 4: 3.6, 8: 6.4, 16: 10.5}


def _time_fn(fn, *args, iters=3):
    fn(*args)  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def _measure_cpu(db: ProfileDB, dtype=torch.float32, quick=True):
    """Real measurements on this host's CPU (1 thread), extrapolated to the
    paper's thread sweep via THREAD_EFF."""
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator().manual_seed(0)
    sweep = MATMUL_SWEEP[::2] if quick else MATMUL_SWEEP
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for (M, N, K) in sweep:
            a = torch.randn((M, K), generator=gen, dtype=dtype)
            b = torch.randn((K, N), generator=gen, dtype=dtype)
            dt = _time_fn(torch.matmul, a, b)
            fl = 2.0 * M * N * K
            by = (M * K + K * N + M * N) * dtype_bytes
            for th in THREAD_COUNTS:
                eff = THREAD_EFF[th]
                for pcie in (False, True):
                    # concurrent PCIe halves effective memory bw
                    slow = 0.55 if pcie else 1.0
                    for dbytes, qf in ((1, 0.8), (2, 1.0), (4, 1.0)):
                        db.add(db.key("cpu", "matmul", dbytes, th, pcie),
                               (M, N, K), fl / dt / 1e9 * eff * slow * qf,
                               by / dt / 1e9 * eff * slow)

        def gqa(q, k, v):
            s = torch.einsum("bthd,bshd->bhts", q, k) / q.shape[-1] ** 0.5
            return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)

        for (t, ctx, H, KV, hd) in (ATTN_SWEEP[::2] if quick
                                    else ATTN_SWEEP):
            q = torch.randn((1, t, KV, hd), generator=gen, dtype=dtype)
            k = torch.randn((1, ctx, KV, hd), generator=gen, dtype=dtype)
            dt = _time_fn(gqa, q, k, k)
            fl = 4.0 * (H / KV) * KV * t * ctx * hd
            by = (2 * ctx * KV * hd + 2 * t * H * hd) * dtype_bytes
            for th in THREAD_COUNTS:
                eff = THREAD_EFF[th]
                for pcie in (False, True):
                    slow = 0.55 if pcie else 1.0
                    for op in ("gqa", "mha"):
                        for dbytes in (1, 2, 4):
                            db.add(db.key("cpu", op, dbytes, th, pcie),
                                   (t, ctx, H, KV, hd),
                                   fl / dt / 1e9 * eff * slow,
                                   by / dt / 1e9 * eff * slow)

        def route(x, w):
            return torch.topk(torch.softmax(x @ w, -1), 8)

        for (t, E) in MOE_SWEEP[:2] if quick else MOE_SWEEP:
            x = torch.randn((t, 512), generator=gen, dtype=dtype)
            w = torch.randn((512, E), generator=gen, dtype=dtype)
            dt = _time_fn(route, x, w)
            fl = 2.0 * t * 512 * E
            for th in THREAD_COUNTS:
                for dbytes in (1, 2, 4):
                    db.add(db.key("cpu", "moe_route", dbytes, th, False),
                           (t, E), fl / dt / 1e9 * THREAD_EFF[th], 10.0)

        def ew(x):
            return F.silu(x) * x

        for (a, b) in ELTWISE_SWEEP:
            x = torch.randn((a, b), generator=gen, dtype=dtype)
            dt = _time_fn(ew, x)
            by = 3.0 * a * b * dtype_bytes
            for th in THREAD_COUNTS:
                for pcie in (False, True):
                    slow = 0.55 if pcie else 1.0
                    for dbytes in (1, 2, 4):
                        db.add(db.key("cpu", "elementwise", dbytes, th, pcie),
                               (a, b),
                               2.0 * a * b / dt / 1e9 * THREAD_EFF[th] * slow,
                               by / dt / 1e9 * THREAD_EFF[th] * slow)
    finally:
        torch.set_num_threads(threads)


def _seed_cpu_analytic(db: ProfileDB, sys: SystemConfig):
    """Analytic CPU entries for *simulated* client systems (cli1/2/3, tpu
    host, h100 host). Framework CPU microbenchmarks are not representative of
    llama.cpp's tuned AVX kernels (its M=1 matvec streams at <1 GB/s), so
    client profiles are derived from datasheet constants: per-thread GFLOPS
    with the measured thread-efficiency curve, and sysRAM bandwidth that a
    few threads saturate. Same schema/lookup as measured profiles — on a
    real client the install phase measures natively (run_install with
    measure_cpu=True)."""
    def reg(op, dims, flops_f, bytes_f):
        for th in THREAD_COUNTS:
            gf_peak = sys.cpu_gflops_per_thread * THREAD_EFF[th] * 1e9
            bw_sat = sys.sysram_gbps * min(1.0, 0.30 + th / 6.0) * 1e9
            for pcie in (False, True):
                bw = bw_sat * (sys.contention_floor + 0.1) if pcie else bw_sat
                for dbytes in (1, 2, 4):
                    fl = flops_f
                    by = bytes_f * dbytes
                    t = max(fl / gf_peak, by / bw, 2e-6)  # launch overhead
                    # entries record achieved FLOPS and the *streaming*
                    # bandwidth (tiny kernels would otherwise corrupt the
                    # roofline knee used for classification)
                    db.add(db.key("cpu", op, dbytes, th, pcie), dims,
                           fl / t / 1e9, bw / 1e9)

    for (M, N, K) in MATMUL_SWEEP:
        reg("matmul", (M, N, K), 2.0 * M * N * K, M * K + K * N + M * N)
    for (t, ctx, H, KV, hd) in ATTN_SWEEP:
        fl = 4.0 * H * t * ctx * hd
        by = 2 * ctx * KV * hd + 2 * t * H * hd
        reg("gqa", (t, ctx, H, KV, hd), fl, by)
        reg("mha", (t, ctx, H, KV, hd), fl, by)
    for (t, E) in MOE_SWEEP:
        reg("moe_route", (t, E), 2.0 * t * 512 * E + 5.0 * t * E,
            t * 512 + 512 * E * 2)
    for (a, b) in ELTWISE_SWEEP:
        reg("elementwise", (a, b), 2.0 * a * b, 3 * a * b)


def _seed_accelerator(db: ProfileDB, sys: SystemConfig):
    """Analytic accelerator entries from datasheet constants.

    Efficiency model: eff = min(1, AI / AI_knee) with a small-kernel launch
    penalty amortised by the paper's ten-async-call measurement trick.
    """
    peak = sys.gpu_tflops * 1e3      # Gflop/s
    bw = sys.gpu_hbm_gbps
    ai_knee = peak / bw

    def add(op, dims, flops, bytes_):
        ai = flops / max(bytes_, 1.0)
        eff = min(1.0, ai / ai_knee)
        # wide-chip small-kernel underutilisation (captured on real systems
        # by the 10-async-launch benchmark)
        occupancy = min(1.0, flops / 2e8) ** 0.35
        gf = max(peak * eff * occupancy, 1.0)
        gb = bw * min(1.0, occupancy * 1.5)
        for dtype_bytes in (1, 2, 4):
            db.add(db.key("gpu", op, dtype_bytes, 0, False), dims, gf, gb)

    for (M, N, K) in MATMUL_SWEEP:
        fl = 2.0 * M * N * K
        add("matmul", (M, N, K), fl, (M * K + K * N + M * N) * 2)
    for (t, ctx, H, KV, hd) in ATTN_SWEEP:
        fl = 4.0 * H * t * ctx * hd
        by = (2 * ctx * KV * hd + 2 * t * H * hd) * 2
        add("gqa", (t, ctx, H, KV, hd), fl, by)
        add("mha", (t, ctx, H, KV, hd), fl, by)
    for (t, E) in MOE_SWEEP:
        add("moe_route", (t, E), 2.0 * t * 512 * E, t * 512 * 2)
    for (a, b) in ELTWISE_SWEEP:
        add("elementwise", (a, b), 2.0 * a * b, 3 * a * b * 2)


def _calibrate_cpu(db: ProfileDB, sys: SystemConfig):
    """Transplant the host-measured CPU profile to the target system.

    Shapes of the measured curves (dims, contention, thread
    scaling) are kept; absolute levels are scaled so 1-thread peak matmul
    matches the target's datasheet per-thread GFLOPS. Documented simulation:
    on a real client the install phase measures natively and no scaling
    applies (scale == 1).
    """
    peak1t = 0.0
    for k, entries in db.entries.items():
        if k[0] == "cpu" and k[1] == "matmul" and k[3] == 1 and not k[4]:
            peak1t = max(peak1t, max(e.gflops for e in entries))
    if peak1t <= 0:
        return
    scale = sys.cpu_gflops_per_thread / peak1t
    mem_scale = sys.sysram_gbps / max(
        max((e.gbps for k, v in db.entries.items() if k[0] == "cpu"
             for e in v), default=1.0), 1e-9)
    for k, entries in db.entries.items():
        if k[0] != "cpu":
            continue
        for e in entries:
            e.gflops *= scale
            e.gbps *= mem_scale
    db.meta["cpu_calibration_scale"] = scale


def run_install(sys: SystemConfig, path: str = None, quick: bool = True,
                measure_cpu: bool = None) -> ProfileDB:
    """measure_cpu=None: measure natively only for the 'local' system (this
    machine); simulated client systems use analytic CPU entries."""
    db = ProfileDB()
    db.meta = {"system": sys.name, "quick": quick}
    if measure_cpu is None:
        measure_cpu = sys.name == "local"
    if measure_cpu:
        _measure_cpu(db, quick=quick)
        _calibrate_cpu(db, sys)
    else:
        _seed_cpu_analytic(db, sys)
    _seed_accelerator(db, sys)
    if path:
        db.save(path)
    return db
