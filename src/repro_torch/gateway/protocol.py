"""OpenAI-compatible wire schema for the serving gateway (DESIGN.md §13).

Request parsing/validation for ``POST /v1/chat/completions`` plus the JSON
bodies of the non-streaming response, the streaming ``chat.completion.chunk``
deltas, ``/v1/models`` and structured errors. Pure data — no sockets, no
asyncio — so the whole surface is unit-testable without a server.

The repo has no text tokenizer (prompts everywhere are int32 token arrays),
so the protocol layer carries BOTH encodings:

- ``token_ids`` (extension field): the prompt as explicit token ids — what
  the benchmarks use to assert gateway tokens bit-identical to a direct
  ``ContinuousBatcher`` run on the same seeded wave;
- ``messages[*].content`` text, folded through a deterministic stub
  tokenizer (stable crc32 word hash into the model vocab) so plain OpenAI
  clients work unmodified. Completions render tokens as space-separated
  ids (``decode_tokens``), which round-trips through ``encode_text``.
"""
from __future__ import annotations

import json
import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional


class GatewayError(Exception):
    """Protocol-level failure carrying its HTTP status + OpenAI error body."""

    def __init__(self, status: int, message: str, *, etype: str = None,
                 code: str = None, retry_after_s: float = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.etype = etype or {400: "invalid_request_error",
                               404: "not_found_error",
                               413: "invalid_request_error",
                               429: "rate_limit_error",
                               503: "service_unavailable_error",
                               }.get(status, "api_error")
        self.code = code
        self.retry_after_s = retry_after_s

    def body(self) -> dict:
        err = {"message": self.message, "type": self.etype}
        if self.code:
            err["code"] = self.code
        return {"error": err}


# ------------------------------------------------------------ stub tokenizer
def encode_text(text: str, vocab: int) -> List[int]:
    """Deterministic stub tokenizer: one token per whitespace word, stable
    crc32 hash into ``[0, vocab)``. A run of decimal ids (the output of
    ``decode_tokens``) maps back to those exact ids, so text round-trips."""
    out = []
    for w in text.split():
        if w.isdigit() and int(w) < vocab:
            out.append(int(w))
        else:
            out.append(zlib.crc32(w.encode("utf-8")) % vocab)
    return out


def decode_tokens(tokens) -> str:
    """Token ids rendered as text (space-separated decimal ids)."""
    return " ".join(str(int(t)) for t in tokens)


# ------------------------------------------------------------ chat request
@dataclass
class ChatRequest:
    """A validated ``/v1/chat/completions`` body."""
    model: str
    prompt_tokens: List[int]
    max_tokens: int
    stream: bool = False
    # serving extensions (DESIGN.md §13): scheduling class + SLO deadline
    priority: float = 0.0
    deadline_s: Optional[float] = None
    client_id: Optional[str] = None
    messages: List[dict] = field(default_factory=list)


def parse_chat_request(body: bytes, *, model_ids: List[str], vocab: int,
                       max_seq: int, default_max_tokens: int = 16
                       ) -> ChatRequest:
    """Parse + validate a chat-completions body.

    Raises ``GatewayError`` with the OpenAI-style status split the tests
    pin: malformed body/fields -> 400, unknown model -> 404, prompt +
    completion budget past the serving window -> 413.
    """
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise GatewayError(400, f"body is not valid JSON: {e}",
                           code="invalid_json")
    if not isinstance(obj, dict):
        raise GatewayError(400, "body must be a JSON object",
                           code="invalid_json")
    model = obj.get("model")
    if not isinstance(model, str) or not model:
        raise GatewayError(400, "'model' must be a non-empty string",
                           code="invalid_model")
    if model not in model_ids:
        raise GatewayError(
            404, f"model {model!r} not found; serving {model_ids}",
            code="model_not_found")
    max_tokens = obj.get("max_tokens", default_max_tokens)
    if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
            or max_tokens < 1:
        raise GatewayError(400, "'max_tokens' must be a positive integer",
                           code="invalid_max_tokens")
    stream = obj.get("stream", False)
    if not isinstance(stream, bool):
        raise GatewayError(400, "'stream' must be a boolean",
                           code="invalid_stream")
    priority = obj.get("priority", 0.0)
    if not isinstance(priority, (int, float)) or isinstance(priority, bool):
        raise GatewayError(400, "'priority' must be a number",
                           code="invalid_priority")
    deadline_s = obj.get("deadline_s")
    if deadline_s is not None and (
            not isinstance(deadline_s, (int, float))
            or isinstance(deadline_s, bool) or deadline_s <= 0):
        raise GatewayError(400, "'deadline_s' must be a positive number",
                           code="invalid_deadline")
    messages = obj.get("messages", [])
    token_ids = obj.get("token_ids")
    if token_ids is not None:
        if (not isinstance(token_ids, list) or not token_ids
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           and 0 <= t < vocab for t in token_ids)):
            raise GatewayError(
                400, f"'token_ids' must be a non-empty list of ints in "
                     f"[0, {vocab})", code="invalid_token_ids")
        prompt = list(token_ids)
    else:
        if not isinstance(messages, list) or not messages:
            raise GatewayError(400, "'messages' must be a non-empty list "
                                    "(or pass 'token_ids')",
                               code="invalid_messages")
        texts = []
        for m in messages:
            if not isinstance(m, dict) or "content" not in m \
                    or not isinstance(m.get("content"), str) \
                    or not isinstance(m.get("role"), str):
                raise GatewayError(
                    400, "each message needs string 'role' and 'content'",
                    code="invalid_messages")
            texts.append(m["content"])
        prompt = encode_text("\n".join(texts), vocab)
        if not prompt:
            raise GatewayError(400, "messages tokenize to an empty prompt",
                               code="empty_prompt")
    if len(prompt) + max_tokens > max_seq:
        # past max_seq the KV write offset clamps and the validity mask
        # saturates — reject at the door (413: the entity is too large for
        # the serving window, not malformed)
        raise GatewayError(
            413, f"prompt ({len(prompt)} tokens) + max_tokens "
                 f"({max_tokens}) exceeds the serving window ({max_seq})",
            code="context_window_exceeded")
    user = obj.get("user")
    client_id = user if isinstance(user, str) and user else None
    return ChatRequest(model=model, prompt_tokens=prompt,
                       max_tokens=max_tokens, stream=stream,
                       priority=float(priority), deadline_s=deadline_s,
                       client_id=client_id, messages=messages)


# ------------------------------------------------------------ responses
def completion_body(req_id: str, model: str, tokens: List[int],
                    prompt_tokens: int, created: Optional[int] = None,
                    finish_reason: str = "length") -> dict:
    return {
        "id": req_id,
        "object": "chat.completion",
        "created": created if created is not None else int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant",
                        "content": decode_tokens(tokens)},
            "finish_reason": finish_reason,
            # extension: exact ids, so clients (and the bit-identity
            # benchmark) never re-tokenize the rendered text
            "token_ids": [int(t) for t in tokens],
        }],
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": len(tokens),
                  "total_tokens": prompt_tokens + len(tokens)},
    }


def chunk_body(req_id: str, model: str, token: Optional[int], index: int,
               created: int, finish_reason: Optional[str] = None) -> dict:
    """One streaming delta. The first chunk (``index == 0``) carries the
    assistant role; the terminal chunk carries ``finish_reason`` and an
    empty delta (OpenAI framing), followed on the wire by ``data: [DONE]``.
    """
    delta = {}
    if token is not None:
        if index == 0:
            delta["role"] = "assistant"
        delta["content"] = (decode_tokens([token])
                            + ("" if finish_reason else " "))
        delta["token_id"] = int(token)
    return {
        "id": req_id,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "delta": delta,
                     "finish_reason": finish_reason}],
    }


def models_body(model_ids: List[str]) -> dict:
    return {"object": "list",
            "data": [{"id": m, "object": "model", "owned_by": "repro"}
                     for m in model_ids]}
