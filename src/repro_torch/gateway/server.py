"""Asyncio HTTP gateway: the network front door over a ``Session``
(DESIGN.md §13).

Architecture (one event loop, one model):

    clients -> HTTP/SSE handlers -> RequestBroker (bounded queue, rate
    windows, priority aging) -> pump task -> ContinuousBatcher.step()
    (one fused iteration per turn, run in a worker thread) -> TokenEvents
    fanned out to per-ticket asyncio queues -> SSE deltas / JSON bodies.

The pump is the ONLY owner of the batcher: admissions, steps, cancels and
rebudgets all pass through it in event-loop order, so the serve loop never
sees concurrent mutation while handlers stay fully async. The batcher step
runs off the event loop — token fan-out, admissions and disconnect
handling interleave with compute instead of waiting for batch completion,
which is what makes the streaming *incremental* (first SSE chunk before
any request finishes). The reference steps on the loop's default pool, a
thread that may differ from one turn to the next; here every step and
re-budget runs on one step thread the gateway owns (and shuts down at
``close``): each thread that runs cuBLAS gets a handle and a workspace of
its own on the card (32 MiB), which a pool of threads would multiply.
PyTorch keeps the current device and stream per thread, so the step
thread enters the batcher's device and its default stream for every call
(``_on_device``) and relies on nothing another thread set.

Endpoints: ``POST /v1/chat/completions`` (streaming + non-streaming),
``GET /v1/models``, ``GET /healthz``, ``GET /metrics``, ``POST
/admin/rebudget`` (live re-plan over the wire, DESIGN.md §8). Stdlib only:
asyncio streams + hand-rolled HTTP/1.1 parsing, ``Connection: close`` per
request.
"""
from __future__ import annotations

import asyncio
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults import FaultPlan
from repro_torch.core.serving import ContinuousBatcher, Request, TokenEvent
from repro_torch.gateway.broker import (QueueFull, RateLimited,
                                        RequestBroker, Ticket)
from repro_torch.gateway.protocol import (GatewayError, chunk_body,
                                          completion_body, models_body,
                                          parse_chat_request)
from repro_torch.gateway.sse import DONE_EVENT, format_event

MAX_BODY_BYTES = 1 << 20        # request bodies past 1MB answer 413
MAX_HEAD_BYTES = 16 << 10


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    return str(o)


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    i = min(len(v) - 1, int(round(q * (len(v) - 1))))
    return v[i]


class Gateway:
    """OpenAI-compatible serving gateway over one session's batcher.

    ``session`` supplies the model/batcher (and the live-replan surface
    for ``/admin/rebudget``); tests may instead pass a bare ``batcher``.
    ``queue_aware=True`` feeds the broker's live queue depth and deadline
    slack into the tier picks each pump turn (DESIGN.md §13);
    ``False`` keeps the queue-blind baseline (the bit-identity reference).
    """

    def __init__(self, session=None, batcher: ContinuousBatcher = None,
                 *, max_batch: int = 4, max_queue: int = 32,
                 rate_limit: Optional[int] = None,
                 rate_window_s: float = 1.0, aging_s: float = 1.0,
                 queue_aware: bool = True, default_max_tokens: int = 16,
                 drain_deadline_s: float = 30.0,
                 faults: Optional[FaultPlan] = None,
                 clock=time.monotonic):
        if (session is None) == (batcher is None):
            raise ValueError("pass exactly one of session= or batcher=")
        self.session = session
        self.batcher = batcher if batcher is not None \
            else session.batcher(max_batch=max_batch)
        self.cfg = self.batcher.cfg
        self.model_ids = [self.cfg.name]
        self.queue_aware = queue_aware
        self.default_max_tokens = default_max_tokens
        self.broker = RequestBroker(max_queue=max_queue,
                                    rate_limit=rate_limit,
                                    rate_window_s=rate_window_s,
                                    aging_s=aging_s, clock=clock)
        self.clock = clock
        self._tickets: Dict[int, Ticket] = {}
        self._queues: Dict[int, asyncio.Queue] = {}
        self._requests: Dict[int, Request] = {}
        self._pending_cancels: List[int] = []
        self._admin: List[Tuple[int, asyncio.Future]] = []
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._step_pool: Optional[ThreadPoolExecutor] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._draining = False
        self._closing = False
        # resilience knobs (DESIGN.md §15): hard drain deadline at close,
        # pump-turn fault injection, and the poisoned-turn counter
        self.drain_deadline_s = drain_deadline_s
        self.faults = faults if faults is not None \
            else (session.faults if session is not None else None)
        self.pump_errors = 0
        self.aborted_on_close = 0
        self.started_at = clock()
        # completed-request latency samples for /metrics percentiles
        self._ttft_samples: List[float] = []
        self._first_chunk_at: Optional[float] = None
        self._first_done_at: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the pump on the running loop (idempotent)."""
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())
        return self

    async def serve_forever(self, host: str = "127.0.0.1", port: int = 0):
        """Real-socket mode: bind, serve until cancelled. Returns the
        bound (host, port) via ``self.bound_address`` once listening."""
        self.start()
        self._server = await asyncio.start_server(self.handle_connection,
                                                  host, port)
        self.bound_address = self._server.sockets[0].getsockname()[:2]
        async with self._server:
            await self._server.serve_forever()

    async def close(self, drain: bool = True,
                    drain_deadline_s: Optional[float] = None):
        """Graceful shutdown (DESIGN.md §13): stop admitting (503), then —
        with ``drain`` — keep stepping until every admitted request has
        finished, OR until the drain deadline (DESIGN.md §15): past it the
        remaining tickets are cancelled, their slots and paged-KV blocks
        freed, and each waiting client answered 503 + Retry-After instead
        of hanging a shutdown forever on one slow request."""
        self._draining = True
        deadline = self.drain_deadline_s if drain_deadline_s is None \
            else drain_deadline_s
        t0 = self.clock()
        if drain and self._wake is not None:
            while (self.broker.depth() or self.broker.active
                   or self.batcher.has_work):
                if self.clock() - t0 >= deadline:
                    self._abort_remaining()
                    break
                self._wake.set()
                await asyncio.sleep(0.005)
        self._closing = True
        if self._wake is not None:
            self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
        # stragglers past the pump's last turn: apply their cancels
        # directly — the pump is gone, and the loop thread owns the batcher
        self._apply_cancels()
        if self._step_pool is not None:
            self._step_pool.shutdown(wait=True)
            self._step_pool = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def _abort_remaining(self):
        """Drain deadline expired: cancel every non-terminal ticket and
        push a shutdown notice (-> 503 + Retry-After) to its waiting
        handler. Slot/paged-block frees ride the normal cancel path."""
        retry = max(1, int(round(self.broker.retry_after_s())))
        for rid, ticket in list(self._tickets.items()):
            if ticket.state in ("done", "cancelled", "failed"):
                continue
            self._cancel_ticket(ticket)
            self.aborted_on_close += 1
            q = self._queues.get(rid)
            if q is not None:
                q.put_nowait(("shutdown", retry))

    # ------------------------------------------------------------ pump
    def _step_thread(self) -> ThreadPoolExecutor:
        """The one thread every batcher step and re-budget runs on."""
        if self._step_pool is None:
            self._step_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gateway-step")
        return self._step_pool

    def _on_device(self, fn, *args):
        """``fn(*args)`` on the calling (pool) thread, inside the batcher's
        CUDA device and its default stream."""
        dev = self.batcher.device
        if dev.type != "cuda":
            return fn(*args)
        with torch.cuda.device(dev), \
                torch.cuda.stream(torch.cuda.default_stream(dev)):
            return fn(*args)

    def _admit_from_broker(self):
        """Move picked tickets into the batcher's admission buffer, at most
        one per free slot — the broker's priority/aging order decides WHO,
        the batcher's slot scan decides WHERE (DESIGN.md §13)."""
        free = sum(1 for s in self.batcher.slots if s is None) \
            - len(self.batcher.pending)
        while free > 0 and self.broker.depth():
            t = self.broker.pick()
            req = Request(rid=t.rid,
                          prompt=np.asarray(t.request.prompt_tokens,
                                            np.int32),
                          max_new_tokens=t.request.max_tokens)
            self._requests[t.rid] = req
            self.batcher.submit([req])
            free -= 1

    def _apply_cancels(self):
        """Free batcher slots of disconnected clients (pump-side half of
        cancellation: the broker side already ran in the handler)."""
        while self._pending_cancels:
            rid = self._pending_cancels.pop()
            self.batcher.cancel(rid)
            self._requests.pop(rid, None)
            self._queues.pop(rid, None)
            self._tickets.pop(rid, None)

    async def _apply_admin(self, loop):
        while self._admin:
            budget_bytes, fut = self._admin.pop(0)
            try:
                diff = await loop.run_in_executor(
                    self._step_thread(), self._on_device,
                    self.batcher.rebudget, budget_bytes)
                if not fut.done():
                    fut.set_result(diff)
            except Exception as e:        # surface to the HTTP caller
                if not fut.done():
                    fut.set_exception(e)

    def _dispatch(self, events: List[TokenEvent]):
        now = self.clock()
        if events and self._first_chunk_at is None:
            self._first_chunk_at = now
        for ev in events:
            ticket = self._tickets.get(ev.rid)
            if ticket is None:            # cancelled between step and fan-out
                continue
            if ev.error is not None:
                # per-request failure (DESIGN.md §15): 500 exactly this
                # client; the batcher already freed the slot, the other
                # slots' events in this batch dispatch normally
                q = self._queues.get(ev.rid)
                if q is not None:
                    q.put_nowait(("error", ev.error))
                self.broker.fail(ticket)
                self._requests.pop(ev.rid, None)
                continue
            if ticket.first_token_at is None:
                ticket.first_token_at = now
                self._ttft_samples.append(now - ticket.arrived_at)
            q = self._queues.get(ev.rid)
            if q is not None:
                q.put_nowait(("token", ev.token, ev.index, ev.done))
            if ev.done:
                if self._first_done_at is None:
                    self._first_done_at = now
                self.broker.complete(ticket, ev.index + 1)

    async def _pump(self):
        loop = asyncio.get_running_loop()
        while True:
            self._apply_cancels()
            await self._apply_admin(loop)
            self._admit_from_broker()
            if self.batcher.has_work:
                if self.queue_aware:
                    self.batcher.set_queue_pressure(
                        self.broker.depth(),
                        slack_s=self.broker.min_slack_s())
                try:
                    if self.faults is not None:
                        self.faults.check("gateway.pump")
                    events = await loop.run_in_executor(
                        self._step_thread(), self._on_device,
                        self.batcher.step)
                except Exception as e:
                    # poisoned turn (DESIGN.md §15): fail the tickets it
                    # was serving — 500 to those clients only — and keep
                    # pumping; queued tickets and future submissions are
                    # untouched
                    self.pump_errors += 1
                    for rid, ticket in list(self._tickets.items()):
                        if ticket.state != "active":
                            continue
                        q = self._queues.get(rid)
                        if q is not None:
                            q.put_nowait(("error", str(e)))
                        self.broker.fail(ticket)
                        self._pending_cancels.append(rid)
                    await asyncio.sleep(0)
                    continue
                self._dispatch(events)
                await asyncio.sleep(0)    # let handlers flush this turn
            elif self._closing or (self._draining
                                   and not self.broker.depth()
                                   and not self.broker.active):
                break
            else:
                self._wake.clear()
                # woken by submit/cancel/admin/close; the timeout guards
                # against a lost wakeup ever stalling the loop for good
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass

    def _wake_pump(self):
        self.start()
        self._wake.set()

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        """Stats snapshot: broker ledger + queue, serving counters from
        ``ContinuousBatcher.stats()``, session planning stats, and
        gateway-side latency percentiles. ``reconciles`` is the ledger
        identity the backpressure tests assert."""
        out = {
            "uptime_s": self.clock() - self.started_at,
            "model": self.model_ids[0],
            "draining": self._draining,
            "queue_depth": self.broker.depth(),
            "active_slots": sum(1 for s in self.batcher.slots
                                if s is not None),
            "broker": self.broker.stats(),
            "ttft_p50_s": _percentile(self._ttft_samples, 0.50),
            "ttft_p99_s": _percentile(self._ttft_samples, 0.99),
            "pump_errors": self.pump_errors,
            "aborted_on_close": self.aborted_on_close,
            "serving": self.batcher.stats(),
        }
        if self.session is not None:
            out["degradation"] = self.session.degradation()
            s = self.session.stats()
            s.pop("serving", None)        # already reported above
            out["session"] = s
        return out

    # ------------------------------------------------------------ http
    async def handle_connection(self, reader, writer):
        """One HTTP/1.1 exchange (``Connection: close``). Works against
        real sockets and the in-process pipe transport alike."""
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, headers, body = req
            await self._route(method, path, headers, body, reader, writer)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass                          # client vanished; nothing to say
        finally:
            try:
                if not writer.is_closing():
                    writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass

    async def _read_request(self, reader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEAD_BYTES:
            return None
        lines = head.decode("latin1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) < 3:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        if n > MAX_BODY_BYTES:
            return method, path, headers, None      # -> 413 in _route
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _route(self, method, path, headers, body, reader, writer):
        try:
            if body is None:
                raise GatewayError(413, "request body exceeds "
                                        f"{MAX_BODY_BYTES} bytes",
                                   code="body_too_large")
            if path == "/healthz" and method == "GET":
                health = {"status": "ok", "model": self.model_ids[0],
                          "draining": self._draining,
                          "pump_errors": self.pump_errors}
                if self.session is not None:
                    deg = self.session.degradation()
                    health["degradation_level"] = deg["level"]
                    health["degradation_rung"] = deg["rung"]
                    if deg["level"] > 0:
                        health["status"] = "degraded"
                await self._respond(writer, 200, health)
            elif path == "/v1/models" and method == "GET":
                await self._respond(writer, 200, models_body(self.model_ids))
            elif path == "/metrics" and method == "GET":
                await self._respond(writer, 200, self.metrics())
            elif path == "/v1/chat/completions" and method == "POST":
                await self._handle_completions(headers, body, reader, writer)
            elif path == "/admin/rebudget" and method == "POST":
                await self._handle_rebudget(body, writer)
            else:
                raise GatewayError(404, f"no route {method} {path}",
                                   code="unknown_route")
        except GatewayError as e:
            extra = {}
            if e.retry_after_s is not None:
                extra["retry-after"] = str(max(1, int(round(e.retry_after_s))))
            await self._respond(writer, e.status, e.body(), extra)

    async def _respond(self, writer, status: int, obj: dict,
                       extra_headers: Optional[dict] = None):
        payload = json.dumps(obj, default=_json_default).encode("utf-8")
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  409: "Conflict", 413: "Payload Too Large",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                "content-type: application/json",
                f"content-length: {len(payload)}",
                "connection: close"]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1")
                     + payload)
        await writer.drain()

    # ------------------------------------------------------------ completions
    def _client_id(self, headers, parsed, writer) -> str:
        if "x-client-id" in headers:
            return headers["x-client-id"]
        if parsed.client_id:
            return parsed.client_id
        peer = writer.get_extra_info("peername")
        return str(peer[0]) if peer else "anonymous"

    async def _handle_completions(self, headers, body, reader, writer):
        parsed = parse_chat_request(
            body, model_ids=self.model_ids, vocab=self.cfg.vocab,
            max_seq=self.batcher.max_seq,
            default_max_tokens=self.default_max_tokens)
        if self._draining or self._closing:
            raise GatewayError(503, "gateway is draining",
                               code="shutting_down", retry_after_s=5)
        try:
            ticket = self.broker.submit(parsed,
                                        self._client_id(headers, parsed,
                                                        writer))
        except QueueFull as e:
            raise GatewayError(429, str(e), code="queue_full",
                               retry_after_s=e.retry_after_s)
        except RateLimited as e:
            raise GatewayError(429, str(e), code="rate_limited",
                               retry_after_s=e.retry_after_s)
        q: asyncio.Queue = asyncio.Queue()
        self._tickets[ticket.rid] = ticket
        self._queues[ticket.rid] = q
        self._wake_pump()
        # watch for the client vanishing mid-generation: EOF on the read
        # side (or a failed SSE write) cancels the ticket, frees the slot
        # and derefs its paged-KV blocks (DESIGN.md §13)
        disconnected = asyncio.ensure_future(reader.read(1))
        try:
            if parsed.stream:
                await self._stream_response(ticket, parsed, q, writer,
                                            disconnected)
            else:
                await self._unary_response(ticket, parsed, q, writer,
                                           disconnected)
        finally:
            disconnected.cancel()
            self._queues.pop(ticket.rid, None)
            self._tickets.pop(ticket.rid, None)

    def _cancel_ticket(self, ticket: Ticket):
        was = self.broker.cancel(ticket)
        if was == "queued":
            # never reached the batcher: nothing to free there
            self._requests.pop(ticket.rid, None)
        elif was == "active":
            self._pending_cancels.append(ticket.rid)
            self._wake_pump()

    async def _next_event(self, q: asyncio.Queue, disconnected):
        """The next token event, or ``None`` if the client disconnected
        first."""
        getter = asyncio.ensure_future(q.get())
        try:
            done, _ = await asyncio.wait(
                {getter, disconnected}, return_when=asyncio.FIRST_COMPLETED)
            if getter in done:
                return getter.result()
            return None
        finally:
            if not getter.done():
                getter.cancel()

    async def _unary_response(self, ticket, parsed, q, writer, disconnected):
        tokens = []
        while True:
            ev = await self._next_event(q, disconnected)
            if ev is None:
                self._cancel_ticket(ticket)
                return
            if ev[0] == "error":
                raise GatewayError(500, f"serving failed: {ev[1]}",
                                   code="internal_error")
            if ev[0] == "shutdown":
                raise GatewayError(
                    503, "gateway shutdown deadline reached before this "
                         "request finished", code="shutting_down",
                    retry_after_s=ev[1])
            _, token, _, done = ev
            tokens.append(token)
            if done:
                break
        await self._respond(writer, 200, completion_body(
            f"chatcmpl-{ticket.rid}", parsed.model, tokens,
            prompt_tokens=len(parsed.prompt_tokens)))

    async def _stream_response(self, ticket, parsed, q, writer,
                               disconnected):
        req_id = f"chatcmpl-{ticket.rid}"
        created = int(time.time())
        head = ["HTTP/1.1 200 OK", "content-type: text/event-stream",
                "cache-control: no-cache", "connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1"))
        await writer.drain()
        while True:
            ev = await self._next_event(q, disconnected)
            if ev is None:
                self._cancel_ticket(ticket)
                return
            if ev[0] == "error":
                # headers are gone; best effort is an error event + close
                writer.write(format_event(
                    {"error": {"message": ev[1], "type": "api_error"}}))
                await writer.drain()
                return
            if ev[0] == "shutdown":
                writer.write(format_event(
                    {"error": {"message": "gateway shutdown deadline "
                                          "reached", "type": "api_error",
                               "code": "shutting_down",
                               "retry_after_s": ev[1]}}))
                await writer.drain()
                return
            _, token, index, done = ev
            try:
                writer.write(format_event(chunk_body(
                    req_id, parsed.model, token, index, created,
                    finish_reason="length" if done else None)))
                await writer.drain()
            except (ConnectionResetError, OSError):
                self._cancel_ticket(ticket)
                return
            if done:
                break
        try:
            writer.write(DONE_EVENT)
            await writer.drain()
        except (ConnectionResetError, OSError):
            pass                          # all tokens delivered; done either way

    # ------------------------------------------------------------ admin
    async def _handle_rebudget(self, body, writer):
        if self.session is None:
            raise GatewayError(409, "rebudget needs a session-backed "
                                    "gateway", code="no_session")
        try:
            obj = json.loads(body.decode("utf-8"))
            budget = obj["budget_bytes"]
            assert isinstance(budget, int) and budget > 0
        except Exception:
            raise GatewayError(400, "body must be {'budget_bytes': <int>}",
                               code="invalid_rebudget")
        fut = asyncio.get_running_loop().create_future()
        self._admin.append((budget, fut))
        self._wake_pump()
        try:
            diff = await fut
        except Exception as e:
            raise GatewayError(400, f"rebudget failed: {e}",
                               code="rebudget_failed")
        await self._respond(writer, 200, {
            "applied": True, "budget_bytes": budget,
            "moved_bytes": diff.moved_bytes, "pins": len(diff.to_pin),
            "evictions": len(diff.to_evict), "summary": diff.summary()})
