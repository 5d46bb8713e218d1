"""Async serving gateway: OpenAI-compatible streaming front door with
admission control and SLO-aware tier scheduling (DESIGN.md §13), over the
port's batcher."""
from repro_torch.gateway.broker import (Ledger, QueueFull, RateLimited,
                                        RequestBroker, Ticket)
from repro_torch.gateway.inproc import InprocClient, PipeEnd, pipe
from repro_torch.gateway.protocol import (ChatRequest, GatewayError,
                                          chunk_body, completion_body,
                                          decode_tokens, encode_text,
                                          models_body, parse_chat_request)
from repro_torch.gateway.server import Gateway
from repro_torch.gateway.sse import DONE_EVENT, format_event, iter_events, \
    parse_stream

__all__ = [
    "ChatRequest", "DONE_EVENT", "Gateway", "GatewayError", "InprocClient",
    "Ledger", "PipeEnd", "QueueFull", "RateLimited", "RequestBroker",
    "Ticket", "chunk_body", "completion_body", "decode_tokens",
    "encode_text", "format_event", "iter_events", "models_body",
    "parse_chat_request", "parse_stream", "pipe",
]
