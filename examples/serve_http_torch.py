"""PyTorch twin of ``serve_http.py``: the async gateway on a real socket
(DESIGN.md §13), over a ``repro_torch.Session`` on the CUDA card unless
``--device cpu``.

Starts the OpenAI-compatible gateway over a ``repro_torch.Session`` (the
smoke config, or the published one under ``--full``), then exercises it
the way an external client would:

1. ``GET /v1/models`` + ``GET /healthz`` via stdlib ``urllib``;
2. a **streaming** chat completion over a raw asyncio connection, printing
   each SSE delta with its per-token wire latency as it arrives;
3. a **non-streaming** completion via ``urllib`` (blocking HTTP, run in a
   worker thread) — same tokens, one JSON body;
4. a mid-serve ``POST /admin/rebudget`` while a second stream is in
   flight: the schedule re-plans live and the stream finishes unperturbed.

    PYTHONPATH=src python examples/serve_http_torch.py [--arch qwen2-0.5b]
    PYTHONPATH=src python examples/serve_http_torch.py --full --port 0
    PYTHONPATH=src python examples/serve_http_torch.py --device cpu

``--port 0`` binds a free port.
"""
import argparse
import asyncio
import json
import time
import urllib.request

from repro_torch import Session
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import CLI2, InferenceSetting, build_graph
from repro_torch.device import resolve_device
from repro_torch.gateway.sse import iter_events

BIND_TIMEOUT_S = 60.0


def http_json(base, path, payload=None, timeout=60):
    """Blocking stdlib request; call via ``asyncio.to_thread``."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


async def stream_chat(host, port, body, tag):
    """Raw-socket SSE client: prints every delta with its wire latency."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    writer.write((f"POST /v1/chat/completions HTTP/1.1\r\n"
                  f"host: {host}\r\ncontent-length: {len(payload)}\r\n"
                  f"\r\n").encode() + payload)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    if b"200" not in head.split(b"\r\n", 1)[0]:
        raise AssertionError(head)
    tokens, t_prev = [], time.perf_counter()
    while True:
        block = await reader.readuntil(b"\n\n")
        now = time.perf_counter()
        for ev in iter_events(block):
            if ev == "[DONE]":
                writer.close()
                await writer.wait_closed()
                return tokens
            delta = json.loads(ev)["choices"][0]["delta"]
            tokens.append(delta["token_id"])
            print(f"    [{tag}] token {delta['token_id']:>5}  "
                  f"(+{(now - t_prev) * 1e3:6.1f} ms)")
        t_prev = now


async def wait_bound(gw, server):
    """The address ``serve_forever`` bound, awaited with a deadline: a
    server that fails before it binds raises its error here."""
    deadline = time.monotonic() + BIND_TIMEOUT_S
    while not hasattr(gw, "bound_address"):
        if server.done():
            server.result()
            raise RuntimeError("the gateway stopped before it bound")
        if time.monotonic() > deadline:
            raise TimeoutError(f"the gateway did not bind in "
                               f"{BIND_TIMEOUT_S:.0f} s")
        await asyncio.sleep(0.01)
    return gw.bound_address


async def serve(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    total = sum(s.weight_bytes for s in build_graph(cfg, wdtype=2))
    sess = Session.open(cfg, CLI2, int(total * 0.2) + 1,
                        InferenceSetting(batch=2, context=128), max_seq=128,
                        device=device)
    gw = sess.gateway(max_batch=2, max_queue=16)
    server = asyncio.ensure_future(gw.serve_forever("127.0.0.1", args.port))
    try:
        host, port = await wait_bound(gw, server)
        out = await exercise(cfg, total, gw, host, port)
    finally:
        server.cancel()
        await gw.close(drain=False)
        try:
            await server
        except asyncio.CancelledError:
            pass
        sess.close()
    print("done.")
    return out


async def exercise(cfg, total, gw, host, port):
    base = f"http://{host}:{port}"
    print(f"[1] gateway listening on {base}")

    models = await asyncio.to_thread(http_json, base, "/v1/models")
    health = await asyncio.to_thread(http_json, base, "/healthz")
    model_ids = [m["id"] for m in models["data"]]
    print(f"    models: {model_ids}, health: {health['status']}")

    print("[2] streaming completion (SSE, per-token wire latency):")
    toks_stream = await stream_chat(host, port, {
        "model": cfg.name, "token_ids": [11, 29, 3, 7],
        "max_tokens": 6, "stream": True}, tag="stream")

    print("[3] same prompt, non-streaming (urllib in a worker thread):")
    resp = await asyncio.to_thread(http_json, base, "/v1/chat/completions", {
        "model": cfg.name, "token_ids": [11, 29, 3, 7], "max_tokens": 6})
    choice = resp["choices"][0]
    print(f"    content: {choice['message']['content']!r}  "
          f"usage: {resp['usage']}")
    if choice["token_ids"] != toks_stream:
        raise AssertionError("stream/unary diverged")
    print("    stream and unary token-identical: OK")

    print("[4] rebudget to 50% mid-stream (live re-plan over the wire):")
    in_flight = asyncio.ensure_future(stream_chat(host, port, {
        "model": cfg.name, "token_ids": [5, 6, 7], "max_tokens": 6,
        "stream": True}, tag="inflight"))
    await asyncio.sleep(0.05)
    re = await asyncio.to_thread(http_json, base, "/admin/rebudget",
                                 {"budget_bytes": int(total * 0.5) + 1})
    print(f"    rebudget applied: {re['summary']}")
    toks_inflight = await in_flight
    baseline = await asyncio.to_thread(http_json, base,
                                       "/v1/chat/completions",
                                       {"model": cfg.name,
                                        "token_ids": [5, 6, 7],
                                        "max_tokens": 6})
    if baseline["choices"][0]["token_ids"] != toks_inflight:
        raise AssertionError("rebudget changed tokens")
    print("    in-flight stream token-identical across the swap: OK")

    m = await asyncio.to_thread(http_json, base, "/metrics")
    led = m["broker"]["ledger"]
    print(f"[5] /metrics: completed={led['completed']} "
          f"reconciles={m['broker']['reconciles']} "
          f"ttft_p50={m['ttft_p50_s'] * 1e3:.0f}ms")
    return {"arch": cfg.name, "models": model_ids,
            "health": health["status"], "stream_tokens": toks_stream,
            "unary_tokens": choice["token_ids"],
            "content": choice["message"]["content"], "usage": resp["usage"],
            "rebudget": re, "inflight_tokens": toks_inflight,
            "baseline_tokens": baseline["choices"][0]["token_ids"],
            "completed": led["completed"],
            "reconciles": m["broker"]["reconciles"],
            "ttft_p50_s": m["ttft_p50_s"]}


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), run the gateway and its
    clients on one event loop, print the reference's lines and return what
    they show."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=list_archs(include_paper=True))
    ap.add_argument("--port", type=int, default=8377)
    ap.add_argument("--full", action="store_true",
                    help="the published config in place of the smoke one")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    return asyncio.run(serve(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
