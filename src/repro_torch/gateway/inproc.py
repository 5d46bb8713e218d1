"""In-process transport for the gateway: duplex byte pipes that duck-type
``(StreamReader, StreamWriter)`` (DESIGN.md §13).

``Gateway.handle_connection`` only ever touches the reader/writer surface
(``read*/write/drain/close/is_closing/wait_closed/get_extra_info``), so a
pair of in-memory pipe ends drives the full HTTP/SSE protocol — request
parsing, admission, streaming fan-out, disconnect cancellation — without
opening a socket. The port's gateway tests and ``chip_smoke.py``'s
gateway phase run on this; ``Gateway.serve_forever`` is the real-socket
path.
"""
from __future__ import annotations

import asyncio
from typing import Optional, Tuple


class PipeEnd:
    """One end of an in-memory duplex byte pipe.

    Exposes a ``reader`` (a real ``asyncio.StreamReader``) for inbound
    bytes plus the ``StreamWriter`` subset for outbound ones. Writing into
    a closed peer raises ``ConnectionResetError`` — the same observable a
    socket gives the server when a client vanished mid-stream, which is
    what the disconnect-cancellation path keys off.
    """

    def __init__(self):
        self.reader = asyncio.StreamReader()
        self.peer: Optional["PipeEnd"] = None
        self._closed = False

    # ---------------------------------------------------- writer surface
    def write(self, data: bytes):
        if self._closed or self.peer._closed:
            raise ConnectionResetError("pipe peer closed")
        self.peer.reader.feed_data(data)

    async def drain(self):
        if self._closed or self.peer._closed:
            raise ConnectionResetError("pipe peer closed")

    def close(self):
        if not self._closed:
            self._closed = True
            self.peer.reader.feed_eof()

    def is_closing(self) -> bool:
        return self._closed

    async def wait_closed(self):
        return

    def get_extra_info(self, name: str, default=None):
        if name == "peername":
            return ("inproc", 0)
        return default


def pipe() -> Tuple[PipeEnd, PipeEnd]:
    """A connected (client_end, server_end) pair."""
    a, b = PipeEnd(), PipeEnd()
    a.peer, b.peer = b, a
    return a, b


class InprocClient:
    """Minimal HTTP/1.1 client over an in-process pipe to one gateway.

    One connection per request (the server answers ``Connection: close``),
    mirroring how ``urllib`` would behave against the real socket server.
    """

    def __init__(self, gateway):
        self.gateway = gateway

    def _connect(self) -> PipeEnd:
        client_end, server_end = pipe()
        asyncio.ensure_future(
            self.gateway.handle_connection(server_end.reader, server_end))
        return client_end

    @staticmethod
    def _request_bytes(method: str, path: str, body: bytes,
                       headers: Optional[dict]) -> bytes:
        head = [f"{method} {path} HTTP/1.1", "host: inproc",
                f"content-length: {len(body)}"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body

    @staticmethod
    async def _read_response(end: PipeEnd) -> Tuple[int, dict, bytes]:
        head = await end.reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        if "content-length" in headers:
            body = await end.reader.readexactly(
                int(headers["content-length"]))
        else:
            body = await end.reader.read()          # until server close
        return status, headers, body

    async def request(self, method: str, path: str, body: bytes = b"",
                      headers: Optional[dict] = None
                      ) -> Tuple[int, dict, bytes]:
        """One full request/response round-trip (drains streams too)."""
        end = self._connect()
        end.write(self._request_bytes(method, path, body, headers))
        try:
            return await self._read_response(end)
        finally:
            end.close()

    async def open_stream(self, method: str, path: str, body: bytes = b"",
                          headers: Optional[dict] = None
                          ) -> Tuple[int, dict, PipeEnd]:
        """Send a request and return after the response head: the caller
        reads SSE bytes incrementally from ``end.reader`` (and may
        ``end.close()`` early to simulate a client disconnect)."""
        end = self._connect()
        end.write(self._request_bytes(method, path, body, headers))
        head = await end.reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers_out = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers_out[k.strip().lower()] = v.strip()
        return status, headers_out, end
