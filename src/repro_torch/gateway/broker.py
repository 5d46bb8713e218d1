"""Request broker: admission control, rate limits, SLO-aware queueing
(DESIGN.md §13).

The broker is the gateway's ledgered waiting line between the protocol
layer and the batcher's decode slots:

- a **bounded queue**: past ``max_queue`` waiting requests, ``submit``
  raises ``QueueFull`` and the server answers 429 with a throughput-derived
  ``Retry-After`` — backpressure is a contract, not best-effort;
- **per-client sliding rate windows**: at most ``rate_limit`` admissions
  per ``rate_window_s`` per client id, old entries evicted as the window
  slides;
- a **starvation-free priority pick**: the pump drains the queue by
  effective priority ``priority + waited/aging_s + urgency(deadline)`` —
  aging grows without bound, so any queued request eventually outranks a
  stream of fresh high-priority arrivals, and a nearing deadline ramps its
  request up by at most one priority class.

Deliberately asyncio-free and clock-injectable: every transition happens on
the event-loop thread, so plain lists are safe, and the tests drive the
rate window / aging logic with a fake clock.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from repro_torch.gateway.protocol import ChatRequest


class QueueFull(Exception):
    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"admission queue full ({depth} waiting)")
        self.depth = depth
        self.retry_after_s = retry_after_s


class RateLimited(Exception):
    def __init__(self, client_id: str, retry_after_s: float):
        super().__init__(f"rate limit exceeded for client {client_id!r}")
        self.client_id = client_id
        self.retry_after_s = retry_after_s


@dataclass
class Ticket:
    """One admitted request's life at the gateway: protocol data + the
    identifiers/timestamps the broker, pump and handler share."""
    rid: int
    request: ChatRequest
    arrived_at: float
    deadline_at: Optional[float] = None
    state: str = "queued"            # queued -> active -> done/cancelled
    picked_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def effective_priority(self, now: float, aging_s: float) -> float:
        """Scheduling key (higher runs first): the declared priority plus
        unbounded queue-aging (starvation freedom) plus a deadline-urgency
        ramp worth at most one priority class as slack approaches zero."""
        eff = self.request.priority + (now - self.arrived_at) / aging_s
        if self.deadline_at is not None:
            slack = self.deadline_at - now
            eff += max(0.0, min(1.0, 1.0 - slack / aging_s))
        return eff

    def slack_s(self, now: float) -> Optional[float]:
        if self.deadline_at is None:
            return None
        return self.deadline_at - now


@dataclass
class Ledger:
    """Admission accounting the /metrics endpoint reconciles against the
    broker's live state: ``received == admitted + rejected_*`` and
    ``admitted == completed + cancelled + failed + queued + active`` at
    all times."""
    received: int = 0
    admitted: int = 0
    rejected_429_queue: int = 0
    rejected_429_rate: int = 0
    completed: int = 0
    cancelled: int = 0
    failed: int = 0
    peak_queue_depth: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class RequestBroker:
    """Bounded, rate-limited, priority-aged admission queue."""

    def __init__(self, max_queue: int = 32, rate_limit: Optional[int] = None,
                 rate_window_s: float = 1.0, aging_s: float = 1.0,
                 clock=time.monotonic):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue})")
        self.max_queue = max_queue
        self.rate_limit = rate_limit
        self.rate_window_s = rate_window_s
        self.aging_s = aging_s
        self.clock = clock
        self.queue: List[Ticket] = []
        self.active: Dict[int, Ticket] = {}
        self.ledger = Ledger()
        self._windows: Dict[str, Deque[float]] = {}
        self._next_rid = 1
        # recent per-token service times, for the Retry-After estimate
        self._token_s = deque(maxlen=64)

    # ------------------------------------------------------------ intake
    def _rate_check(self, client_id: str, now: float):
        if self.rate_limit is None:
            return
        win = self._windows.setdefault(client_id, deque())
        while win and now - win[0] >= self.rate_window_s:
            win.popleft()           # slide: evict entries past the window
        if len(win) >= self.rate_limit:
            raise RateLimited(client_id,
                              retry_after_s=self.rate_window_s
                              - (now - win[0]))
        win.append(now)

    def retry_after_s(self) -> float:
        """Backpressure hint: how long until queue headroom plausibly
        exists — the queue's outstanding token work over the recent
        serving rate (floored at 1s when nothing has completed yet)."""
        outstanding = sum(t.request.max_tokens for t in self.queue)
        if not self._token_s or outstanding == 0:
            return 1.0
        per_token = sum(self._token_s) / len(self._token_s)
        return max(1.0, outstanding * per_token)

    def submit(self, request: ChatRequest,
               client_id: Optional[str] = None) -> Ticket:
        """Admit into the bounded queue. Raises ``RateLimited`` /
        ``QueueFull`` (both -> 429 upstream, different codes)."""
        now = self.clock()
        self.ledger.received += 1
        try:
            self._rate_check(client_id or request.client_id or "anonymous",
                             now)
        except RateLimited:
            self.ledger.rejected_429_rate += 1
            raise
        if len(self.queue) >= self.max_queue:
            self.ledger.rejected_429_queue += 1
            raise QueueFull(len(self.queue), self.retry_after_s())
        t = Ticket(rid=self._next_rid, request=request, arrived_at=now,
                   deadline_at=(now + request.deadline_s
                                if request.deadline_s else None))
        self._next_rid += 1
        self.queue.append(t)
        self.ledger.admitted += 1
        self.ledger.peak_queue_depth = max(self.ledger.peak_queue_depth,
                                           len(self.queue))
        return t

    # ------------------------------------------------------------ scheduling
    def pick(self) -> Optional[Ticket]:
        """Pop the queued ticket with the highest effective priority
        (aging + deadline urgency; FIFO on exact ties via the stable max
        over arrival order). Returns ``None`` on an empty queue."""
        if not self.queue:
            return None
        now = self.clock()
        best_i = 0
        best_key = self.queue[0].effective_priority(now, self.aging_s)
        for i in range(1, len(self.queue)):
            key = self.queue[i].effective_priority(now, self.aging_s)
            if key > best_key:      # strict: equal keys keep the earlier
                best_i, best_key = i, key
        t = self.queue.pop(best_i)
        t.state = "active"
        t.picked_at = now
        self.active[t.rid] = t
        return t

    def depth(self) -> int:
        return len(self.queue)

    def min_slack_s(self) -> Optional[float]:
        """Tightest deadline slack across queued + active tickets — the
        SLO signal the tier picks consume (DESIGN.md §13)."""
        now = self.clock()
        slacks = [s for t in list(self.queue) + list(self.active.values())
                  if (s := t.slack_s(now)) is not None]
        return min(slacks) if slacks else None

    # ------------------------------------------------------------ outcomes
    def complete(self, ticket: Ticket, generated_tokens: int):
        if ticket.state in ("done", "cancelled", "failed"):
            return                  # already terminal: keep the ledger exact
        ticket.state = "done"
        ticket.finished_at = self.clock()
        if ticket.picked_at is not None and generated_tokens > 0:
            self._token_s.append((ticket.finished_at - ticket.picked_at)
                                 / generated_tokens)
        self.active.pop(ticket.rid, None)
        self.ledger.completed += 1

    def cancel(self, ticket: Ticket) -> str:
        """Client went away: forget a queued ticket, or mark an active one
        cancelled (the pump frees its batcher slot). Idempotent."""
        if ticket.state in ("done", "cancelled"):
            return ticket.state
        was = ticket.state
        ticket.state = "cancelled"
        ticket.finished_at = self.clock()
        if was == "queued":
            self.queue.remove(ticket)
        else:
            self.active.pop(ticket.rid, None)
        self.ledger.cancelled += 1
        return was

    def fail(self, ticket: Ticket):
        """Per-request servicing failure (DESIGN.md §15): the batcher
        failed exactly this request — its slot freed, its client gets an
        error — terminal like ``complete`` but ledgered separately so
        /metrics can tell fault-500s from clean completions. Idempotent."""
        if ticket.state in ("done", "cancelled", "failed"):
            return
        was = ticket.state
        ticket.state = "failed"
        ticket.finished_at = self.clock()
        if was == "queued":
            self.queue.remove(ticket)
        else:
            self.active.pop(ticket.rid, None)
        self.ledger.failed += 1

    # ------------------------------------------------------------ reporting
    def reconciles(self) -> bool:
        """The ledger identity /metrics asserts (and the tests pin)."""
        led = self.ledger
        return (led.received == led.admitted + led.rejected_429_queue
                + led.rejected_429_rate
                and led.admitted == led.completed + led.cancelled
                + led.failed + len(self.queue) + len(self.active))

    def stats(self) -> dict:
        return {
            "queue_depth": len(self.queue),
            "active": len(self.active),
            "min_slack_s": self.min_slack_s(),
            "retry_after_s": self.retry_after_s(),
            "ledger": self.ledger.as_dict(),
            "reconciles": self.reconciles(),
            "rate_clients": len(self._windows),
        }
