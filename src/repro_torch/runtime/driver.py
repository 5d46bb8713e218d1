"""Fault-tolerant training driver: the reference's ``runtime/driver.py`` on
one card.

- **checkpoint / restart**: periodic async checkpoints; any step failure
  restores the last good checkpoint and replays the data stream from the
  restored step (the pipeline is addressable by step, so replay is
  exact).
- **straggler watch**: each step is timed, its metrics read back to the
  host (``float`` of each, which waits for the card: the reference's
  ``block_until_ready``); a step over ``straggler_factor`` x the trailing
  median is logged as an event.
- **fault injection** for tests: ``FaultInjector`` raises at chosen steps.

The reference's elastic ``remesh`` (re-jit the step and re-place the
state on a new device mesh) has no counterpart: one card has no mesh to
change, and the checkpoint format, which is mesh-agnostic, is the way a
run moves between machines.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.common import tree_flatten


class FaultInjector:
    """Deterministically raise at given step numbers (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


class TrainDriver:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` over
    ``pipeline.batch_at(step)``. ``events``: (step, kind, detail) tuples
    with kind "fault", "restart" or "straggler"; ``metrics_log``: one dict
    of floats per completed step (steps replayed after a restart appear
    again); ``step_seconds``: each completed step's wall time."""

    def __init__(self, step_fn: Callable, state: Any, pipeline, ckpt_dir: str,
                 ckpt_every: int = 50, keep: int = 3,
                 straggler_factor: float = 3.0,
                 fault_injector: Optional[FaultInjector] = None):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.fault = fault_injector or FaultInjector()
        self.step = 0
        self.metrics_log = []
        self.step_seconds = []
        self.events = []  # (step, kind, detail): restarts, stragglers
        self._latencies = []

    def _device(self):
        leaves, _ = tree_flatten(self.state)
        return next((x.device for x in leaves if torch.is_tensor(x)), None)

    # ---------------- fault tolerance ----------------
    def _restore(self):
        state, step, _ = self.manager.restore(self.state,
                                              device=self._device())
        self.state = state
        self.step = step
        self.events.append((step, "restart", "restored from checkpoint"))

    # ---------------- main loop ----------------
    def run(self, n_steps: int, max_restarts: int = 3):
        restarts = 0
        # step-0 checkpoint so the first failure has something to restore
        self.manager.save(self.step, self.state, {"note": "initial"})
        self.manager.wait()
        while self.step < n_steps:
            batch = self.pipeline.batch_at(self.step)
            t0 = time.perf_counter()
            try:
                self.fault.check(self.step)
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception as e:  # noqa: BLE001 — any failure restarts
                restarts += 1
                self.events.append((self.step, "fault", repr(e)))
                if restarts > max_restarts:
                    raise
                self._restore()
                continue
            dt = time.perf_counter() - t0
            self._watch_stragglers(dt)
            self.step_seconds.append(dt)
            self.metrics_log.append(metrics)
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.manager.save(self.step, self.state, {"note": "periodic"})
        self.manager.save(self.step, self.state, {"note": "final"})
        self.manager.wait()
        return self.metrics_log

    def _watch_stragglers(self, dt: float):
        if len(self._latencies) >= 5:
            med = statistics.median(self._latencies[-20:])
            if dt > self.straggler_factor * med:
                self.events.append(
                    (self.step, "straggler",
                     f"step took {dt:.3f}s vs median {med:.3f}s"))
        self._latencies.append(dt)
