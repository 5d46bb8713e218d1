"""Core runtime of the port: planning (jax-free copies of the reference) and
the execution path on PyTorch: dense and MoE decoders, stacked or paged KV,
speculative decoding, fault injection and the degradation ladder."""
from repro_torch.core.costmodel import Placement, Plan, TimingEstimator  # noqa: F401
from repro_torch.core.executor import ExecStats, PipelinedExecutor  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    DEGRADATION_RUNGS, AllocationFault, DemandTimeout, FaultError,
    FaultPlan, FaultSpec, RecoveryPolicy, TransferFault, WorkerCrash,
    WorkerLost)
from repro_torch.core.graphing import (  # noqa: F401
    build_graph, total_kv_bytes, total_weight_bytes)
from repro_torch.core.install import run_install  # noqa: F401
from repro_torch.core.kvpaged import (  # noqa: F401
    PageAllocator, PagedKVCache, PagePoolFull)
from repro_torch.core.planner import (  # noqa: F401
    PINNED_COMPUTE_KINDS, TIERS, Schedule, ScheduleDiff, build_schedule,
    choose_spec_k, estimate_spec_tps, estimate_tps, estimate_ttft,
    plan_draft_carve)
from repro_torch.core.prefetch import PrefetchEngine, PrefetchStats  # noqa: F401
from repro_torch.core.profile_db import ProfileDB  # noqa: F401
from repro_torch.core.serving import (  # noqa: F401
    ContinuousBatcher, Request, TokenEvent, random_requests)
from repro_torch.core.specdec import SpecDecoder  # noqa: F401
from repro_torch.core.sublayer import STREAMABLE_KINDS  # noqa: F401
from repro_torch.core.system import (  # noqa: F401
    CLI1, CLI2, CLI3, H100, LOCAL, SYSTEMS, TPU_V5E, InferenceSetting,
    SystemConfig)
