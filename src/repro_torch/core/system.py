"""System descriptions: the paper's client systems + the TPU-pod analogue.

Pipelined sharding plans against a *two-tier memory system with two compute
engines connected by a link*. On clients: (sysRAM+CPU) <-PCIe-> (VRAM+GPU).
On a TPU v5e host: (host RAM + host CPU) <-PCIe-> (HBM + TPU core). The same
planner runs for both; only the constants change (DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class SystemConfig:
    name: str
    # fast-tier compute engine ("gpu" in paper terms; TPU core here)
    gpu_tflops: float          # peak dense TFLOP/s (fp16/bf16)
    gpu_hbm_gbps: float        # fast-tier memory bandwidth
    vram_gb: float             # fast-tier capacity (the *max* budget)
    # slow-tier compute engine (host CPU)
    cpu_threads: int
    cpu_gflops_per_thread: float
    sysram_gbps: float         # host memory bandwidth
    # link
    link_gbps: float           # PCIe (client) / PCIe host link (TPU)
    # fraction of sysram bw the CPU retains while the link is saturated
    contention_floor: float = 0.45

    def with_(self, **kw):
        return replace(self, **kw)


# The paper's evaluation clients (Table 3), with public-spec compute numbers.
CLI1 = SystemConfig(  # laptop: RTX 3500 Ada / Ultra7 / PCIe gen4 x8-ish
    name="cli1", gpu_tflops=32.0, gpu_hbm_gbps=432.0, vram_gb=12.0,
    cpu_threads=16, cpu_gflops_per_thread=28.0, sysram_gbps=119.5,
    link_gbps=13.0)
CLI2 = SystemConfig(  # desktop: RTX 5070 Ti / Ryzen7 / PCIe gen5
    name="cli2", gpu_tflops=62.0, gpu_hbm_gbps=896.0, vram_gb=16.0,
    cpu_threads=8, cpu_gflops_per_thread=35.0, sysram_gbps=57.6,
    link_gbps=50.0)
CLI3 = SystemConfig(  # high-end: RTX 5090 / EPYC / PCIe gen5
    name="cli3", gpu_tflops=105.0, gpu_hbm_gbps=1790.0, vram_gb=32.0,
    cpu_threads=16, cpu_gflops_per_thread=32.0, sysram_gbps=153.6,
    link_gbps=50.0)

# TPU v5e chip + its host slice (the adaptation target; per-chip view).
TPU_V5E = SystemConfig(
    name="tpu-v5e", gpu_tflops=197.0, gpu_hbm_gbps=819.0, vram_gb=16.0,
    cpu_threads=28, cpu_gflops_per_thread=20.0, sysram_gbps=100.0,
    link_gbps=32.0)

# the host the program runs on — CPU entries are *measured* at install time
LOCAL = SystemConfig(
    name="local", gpu_tflops=1.0, gpu_hbm_gbps=10.0, vram_gb=4.0,
    cpu_threads=1, cpu_gflops_per_thread=30.0, sysram_gbps=10.0,
    link_gbps=8.0)

# One NVIDIA H100 SXM and its host, the port's target. GPU figures are from
# NVIDIA's H100 data sheet (SXM5: 989 TFLOP/s dense bf16, 3350 GB/s HBM3,
# 80 GB). The host figures are nominal for an 8-core host slice; the link is
# measured on the card (pinned host->device copies timed with CUDA events,
# chip_smoke.py) and passed in as SYSTEMS["h100"].with_(link_gbps=...).
H100 = SystemConfig(
    name="h100", gpu_tflops=989.0, gpu_hbm_gbps=3350.0, vram_gb=80.0,
    cpu_threads=8, cpu_gflops_per_thread=30.0, sysram_gbps=100.0,
    link_gbps=25.0)

SYSTEMS = {s.name: s for s in (CLI1, CLI2, CLI3, TPU_V5E, LOCAL, H100)}


@dataclass(frozen=True)
class InferenceSetting:
    """The paper's 'inference conditions'."""
    batch: int = 1
    context: int = 4096          # ISL + reserved output
    max_new_tokens: int = 256
    kv_dtype_bytes: int = 2
    weight_dtype_bytes: int = 2
    act_dtype_bytes: int = 2     # activation dtype width (bf16 default)
