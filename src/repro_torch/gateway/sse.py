"""Server-sent-events framing for the streaming chat endpoint
(DESIGN.md §13).

OpenAI streams completions as SSE ``data:`` lines, one JSON chunk per
event, terminated by a literal ``data: [DONE]``. This module owns exactly
that byte framing — the server writes what these helpers return, and the
tests parse responses back through ``iter_events`` so framing drift breaks
loudly.
"""
from __future__ import annotations

import json
from typing import Iterator, List, Tuple

DONE_EVENT = b"data: [DONE]\n\n"


def format_event(obj: dict) -> bytes:
    """One SSE event: ``data: <json>\\n\\n`` (single-line payload — json
    compact separators never emit raw newlines)."""
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode("utf-8") \
        + b"\n\n"


def iter_events(payload: bytes) -> Iterator[str]:
    """Split a raw SSE byte stream into event payload strings (the text
    after ``data: ``), tolerating a trailing partial event."""
    for block in payload.split(b"\n\n"):
        if not block.strip():
            continue
        for line in block.split(b"\n"):
            if line.startswith(b"data: "):
                yield line[len(b"data: "):].decode("utf-8")


def parse_stream(payload: bytes) -> Tuple[List[dict], bool]:
    """Decode a finished SSE stream: (JSON chunks, saw ``[DONE]``)."""
    chunks, done = [], False
    for ev in iter_events(payload):
        if ev == "[DONE]":
            done = True
        else:
            chunks.append(json.loads(ev))
    return chunks, done
