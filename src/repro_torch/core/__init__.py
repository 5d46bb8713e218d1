"""Core runtime of the port: planning (jax-free copies of the reference) and
the dense stacked-KV execution path on PyTorch."""
from repro_torch.core.costmodel import Placement, Plan, TimingEstimator  # noqa: F401
from repro_torch.core.executor import ExecStats, PipelinedExecutor  # noqa: F401
from repro_torch.core.graphing import (  # noqa: F401
    build_graph, total_kv_bytes, total_weight_bytes)
from repro_torch.core.install import run_install  # noqa: F401
from repro_torch.core.planner import (  # noqa: F401
    TIERS, Schedule, ScheduleDiff, build_schedule, estimate_tps,
    estimate_ttft)
from repro_torch.core.prefetch import PrefetchEngine, PrefetchStats  # noqa: F401
from repro_torch.core.profile_db import ProfileDB  # noqa: F401
from repro_torch.core.serving import (  # noqa: F401
    ContinuousBatcher, Request, TokenEvent, random_requests)
from repro_torch.core.sublayer import STREAMABLE_KINDS  # noqa: F401
from repro_torch.core.system import (  # noqa: F401
    CLI1, CLI2, CLI3, H100, LOCAL, SYSTEMS, TPU_V5E, InferenceSetting,
    SystemConfig)
