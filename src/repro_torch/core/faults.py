"""Deterministic fault injection + recovery policy for the streaming
pipeline (DESIGN.md §15).

On real clients the conditions the paper adapts to include a saturated
PCIe link, VRAM pressure from other apps, and background threads dying.
Every background surface of this repo — the static prefetch worker, the
demand pool, the executor's pass allocations, the paged-KV prepare, the
serving batcher, the gateway pump — gets a *named injection point* here
so chaos tests and benchmarks can trigger those conditions exactly once,
at an exact hit, and replay them bit-for-bit.

Two design rules keep the harness honest:

- **Deterministic.** A ``FaultPlan`` is a list of ``FaultSpec``s; each
  spec counts the ``check()`` calls that match its (point, key-substring)
  filter and fires on hits ``[after, after + count)``. No wall clock, no
  ambient randomness: the same plan against the same serve produces the
  same fired log (``FaultPlan.fired``), which is what lets the chaos
  matrix assert token bit-identity against an undisturbed run.
- **Zero-overhead default.** Every instrumented call site guards with
  ``if faults is not None`` — a session built without a plan executes
  byte-for-byte the same code as before this module existed.

``RecoveryPolicy`` is the other half: the bounded-retry/backoff and
demand-deadline knobs the recovery paths consume. It is deliberately
separate from ``FaultPlan`` — recovery is always on (real transfers can
really fail); injection is opt-in.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# Injection-point catalog (DESIGN.md §15). Adding a point means adding a
# ``faults.check(point, key)`` call at the new surface AND a row here —
# ``FaultSpec`` validates against this set so a typo'd point in a test
# fails loudly instead of never firing.
POINTS = frozenset({
    "prefetch.copy",    # static stage copy, per attempt (PrefetchEngine)
    "demand.copy",      # demand stage copy, per attempt (expert/kv_page)
    "prefetch.worker",  # static worker loop, per item (before staging)
    "demand.worker",    # demand worker loop, per item (before staging)
    "demand.timeout",   # demand acquire: force a deadline expiry
    "alloc.device",     # device allocation at executor pass entry
    "alloc.host",       # host/pool allocation in PagedKVCache.prepare_*
    "serving.request",  # per-request servicing in ContinuousBatcher
    "gateway.pump",     # one gateway pump turn
})

MODES = frozenset({"fail", "delay", "crash", "oom", "timeout"})

# Emergency-rebudget ladder rungs, mildest first (DESIGN.md §15).
DEGRADATION_RUNGS = ("full", "spec_off", "expert_shrink", "tier_down",
                     "sync")


class FaultError(RuntimeError):
    """Base class of every injected fault."""


class TransferFault(FaultError):
    """A host->device copy failed (mode ``fail``)."""


class WorkerCrash(FaultError):
    """A transfer worker thread died (mode ``crash``)."""


class AllocationFault(FaultError):
    """A host/device allocation failed (mode ``oom``). The serving layer
    answers this by stepping down the degradation ladder."""


class DemandTimeout(FaultError):
    """A demanded shard missed its deadline — raised both by injection
    (mode ``timeout``) and organically by ``PrefetchEngine.acquire`` when
    a real deadline expires."""


class WorkerLost(RuntimeError):
    """Surfaced to ``acquire()``/``request()`` callers whose transfer
    worker died (satellite: silent worker death). NOT a ``FaultError`` —
    it is the *recovery-side* signal, whatever killed the worker."""


_MODE_EXC = {"fail": TransferFault, "crash": WorkerCrash,
             "oom": AllocationFault, "timeout": DemandTimeout}


@dataclass
class FaultSpec:
    """One scripted fault: fire ``mode`` at hits ``[after, after+count)``
    of ``point`` (counting only ``check()`` calls whose key contains
    ``key``, when given)."""
    point: str
    mode: str = "fail"
    after: int = 0
    count: int = 1
    delay_s: float = 0.0
    key: Optional[str] = None

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"catalog: {sorted(POINTS)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"modes: {sorted(MODES)}")
        if self.mode == "delay" and self.delay_s <= 0.0:
            raise ValueError("delay fault needs delay_s > 0")
        if self.after < 0 or self.count < 1:
            raise ValueError("need after >= 0 and count >= 1")


class FaultPlan:
    """Seeded, clock-injectable fault registry.

    ``check(point, key)`` is the single instrumented entry: it advances
    the per-spec hit counters under a lock (transfer workers call from
    their own threads) and either returns, sleeps (``delay``), or raises
    the mode's exception class. ``seed`` only labels the plan — firing is
    a pure function of the hit sequence, so replaying the same serve
    replays the same faults.
    """

    def __init__(self, specs: List[FaultSpec] = (), seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.seed = seed
        self.clock = clock
        self.sleep = sleep
        self.hits: Dict[str, int] = {}
        self.fired: List[dict] = []
        self._seen = [0] * len(self.specs)
        self._lock = threading.Lock()

    def check(self, point: str, key: str = "") -> None:
        """Advance ``point``'s hit counters; fire any spec whose window
        covers this hit. Raises the mode's exception for fail/crash/oom/
        timeout, sleeps for delay, else returns."""
        delay = 0.0
        err: Optional[FaultError] = None
        with self._lock:
            self.hits[point] = self.hits.get(point, 0) + 1
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.key is not None and spec.key not in key:
                    continue
                hit = self._seen[i]
                self._seen[i] += 1
                if not (spec.after <= hit < spec.after + spec.count):
                    continue
                self.fired.append({"point": point, "key": key,
                                   "mode": spec.mode, "hit": hit,
                                   "at": self.clock()})
                if spec.mode == "delay":
                    delay = max(delay, spec.delay_s)
                elif err is None:
                    err = _MODE_EXC[spec.mode](
                        f"injected {spec.mode} at {point} ({key or '-'}, "
                        f"hit {hit})")
        if delay > 0.0:
            self.sleep(delay)
        if err is not None:
            raise err

    def counters(self) -> dict:
        """Stats-surface snapshot: per-point hit totals and fired totals
        per (point, mode)."""
        with self._lock:
            fired: Dict[str, int] = {}
            for f in self.fired:
                k = f"{f['point']}:{f['mode']}"
                fired[k] = fired.get(k, 0) + 1
            return {"seed": self.seed, "hits": dict(self.hits),
                    "fired": fired, "fired_total": len(self.fired)}


@dataclass
class RecoveryPolicy:
    """Knobs for the always-on recovery paths (DESIGN.md §15).

    - stage copies retry up to ``max_copy_retries`` times with
      exponential backoff ``backoff_base_s * backoff_mult**attempt``;
    - demand acquires wait at most ``demand_deadline_s`` before the
      executor abandons the slot and sync-fetches the shard itself;
    - ``crash_tolerance`` worker deaths flip the executor's watchdog to
      the permanent ``overlap=False`` sync path.

    ``sleep`` is injectable so tests back off without wall-clock cost.
    """
    max_copy_retries: int = 3
    backoff_base_s: float = 0.002
    backoff_mult: float = 2.0
    demand_deadline_s: Optional[float] = 5.0
    crash_tolerance: int = 1
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def backoff_s(self, attempt: int) -> float:
        return self.backoff_base_s * self.backoff_mult ** attempt

    def retryable(self, exc: BaseException) -> bool:
        """Retry plain transfer failures; an allocation fault only gets
        worse under retry (the ladder handles it) and anything
        non-``Exception`` (KeyboardInterrupt, ...) must propagate."""
        return isinstance(exc, Exception) and \
            not isinstance(exc, (AllocationFault, WorkerCrash))


__all__ = [
    "POINTS", "MODES", "DEGRADATION_RUNGS", "FaultError", "TransferFault",
    "WorkerCrash", "AllocationFault", "DemandTimeout", "WorkerLost",
    "FaultSpec", "FaultPlan", "RecoveryPolicy",
]
