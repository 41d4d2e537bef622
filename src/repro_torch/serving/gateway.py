"""Async HTTP/SSE serving gateway: a real network frontend for the
cluster runtime (port of ``repro/serving/gateway.py``).

``SSEGateway`` fronts a ``ClusterFrontend`` (or single-replica
``ServingFrontend``) with a dependency-free asyncio HTTP/1.1 server:

* ``POST /v1/generate`` — submit a request (JSON body carrying its SLO
  class and prompt) and stream its tokens back as Server-Sent Events.
* ``GET /metrics`` — Prometheus exposition of the cluster telemetry
  registry plus the step time series (wall-clock mode when enabled).
* ``GET /healthz`` — liveness + accepting state.
* ``POST /admin/drain`` — begin graceful removal of one replica
  (``ClusterFrontend.drain_replica``); live streams keep flowing.

The cluster's step loop runs as a background asyncio task (the *pump*):
it steps whenever any replica has work and parks on an event otherwise,
so an idle gateway burns no CPU.  Time stays split exactly as in the
in-process drivers — SLO accounting runs on the deterministic virtual
clock (a request's ``arrival`` is the virtual now at HTTP intake), while
the telemetry step series can additionally carry wall-clock timestamps
(``ClusterTelemetry(wall_clock=True)``).

Conformance contract (tests/test_gateway.py): for the same prompts and
submission order, the SSE token stream of every request is bit-identical
to driving the same cluster in process — the gateway adds transport, not
behavior.  A client disconnect mid-stream cancels the request through
``ClusterFrontend.cancel`` (engine drop: pages and sequence slot
released, shared budget credited); graceful ``shutdown(drain=True)``
stops intake but pumps until every accepted stream has completed.

SSE wire format (one event per engine-batch token chunk)::

    event: start          {"rid": 3, "slo_class": "tpot=0.05"}
    event: token          {"tokens": [17, 401]}
    event: done           {"attained": true, "dropped": false, "t": 1.25}

Event payloads are deterministic (sorted keys, virtual times only), so
stream bytes are reproducible run-to-run and invariant to telemetry
being on or off.

This module is the reference's with its imports rewritten: it is asyncio
and numpy only, holds the cluster by duck type and makes no tensor call,
and the wire format and payload rules are the same byte for byte.  The
one addition is device discipline in ``run_in_thread``: the CUDA current
device is per thread, so the gateway thread, which runs every
``cluster.step()``, first binds the device of the cluster's engines
before it steps them (``_bind_engine_device``).  One repair: graceful
``shutdown`` awaits the listener's ``wait_closed`` after the drain, not
before it (since Python 3.12.1 that call waits for every open
connection, so the reference's order waits forever whenever a stream is
open at shutdown).
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import threading
from typing import Optional

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.slo import (StageSpec, prefill_slo, decode_slo,
                                  TIGHT_TTFT_SLOWDOWN, LOOSE_TTFT_SLOWDOWN,
                                  TIGHT_TPOT, LOOSE_TPOT, SPEC_TPOT)
from repro_torch.telemetry.instruments import slo_class_of

# Named SLO classes accepted in request payloads (paper Table 3 tiers);
# explicit ``ttft_slowdown`` / ``tpot`` fields override the named tier.
SLO_CLASSES = {
    "tight": (TIGHT_TTFT_SLOWDOWN, TIGHT_TPOT),
    "loose": (LOOSE_TTFT_SLOWDOWN, LOOSE_TPOT),
    "spec":  (LOOSE_TTFT_SLOWDOWN, SPEC_TPOT),
}

_MAX_HEADER = 64 * 1024
_MAX_BODY = 8 * 1024 * 1024


class PayloadError(ValueError):
    """Invalid /v1/generate request body (HTTP 400)."""


def request_from_payload(payload: dict, rid: int, arrival: float,
                         ) -> tuple[Request, Optional[list]]:
    """Build a ``Request`` (+ optional explicit prompt) from a JSON
    payload.  Either a full ``stages`` list or the two-stage shorthand
    (``slo``/``ttft_slowdown``/``tpot`` + ``prompt_len``/``output_len``)
    is accepted; ``prompt`` pins the exact token ids (required for
    stream-conformance testing — a generated prompt depends on which
    replica's rng serves the request)."""
    prompt = payload.get("prompt")
    if prompt is not None:
        if (not isinstance(prompt, list)
                or not all(isinstance(t, int) for t in prompt)):
            raise PayloadError("prompt must be a list of token ids")
        prompt = list(prompt)
    if "stages" in payload:
        stages = []
        for s in payload["stages"]:
            kind = s.get("kind")
            length = int(s.get("length", 0))
            if length <= 0:
                raise PayloadError("stage length must be positive")
            if kind == "prefill":
                stages.append(StageSpec(
                    prefill_slo(float(s.get("ttft_slowdown",
                                            LOOSE_TTFT_SLOWDOWN))), length))
            elif kind == "decode":
                stages.append(StageSpec(
                    decode_slo(float(s.get("tpot", LOOSE_TPOT))), length))
            else:
                raise PayloadError(f"unknown stage kind {kind!r}")
        if not stages:
            raise PayloadError("stages must be non-empty")
    else:
        tier = payload.get("slo", "loose")
        if tier not in SLO_CLASSES:
            raise PayloadError(f"unknown slo class {tier!r} "
                               f"(one of {sorted(SLO_CLASSES)})")
        ttft, tpot = SLO_CLASSES[tier]
        ttft = float(payload.get("ttft_slowdown", ttft))
        tpot = float(payload.get("tpot", tpot))
        plen = len(prompt) if prompt is not None \
            else int(payload.get("prompt_len", 0))
        if plen <= 0:
            raise PayloadError("prompt or prompt_len required")
        out = int(payload.get("output_len", 16))
        if out <= 0:
            raise PayloadError("output_len must be positive")
        stages = [StageSpec(prefill_slo(ttft), plen),
                  StageSpec(decode_slo(tpot), out)]
    if prompt is not None and stages[0].kind.value == "prefill" \
            and stages[0].length != len(prompt):
        # the engine prefills exactly the prompt: keep them consistent
        stages[0] = StageSpec(stages[0].slo, len(prompt))
    return Request(rid, arrival, stages=stages), prompt


@dataclasses.dataclass
class GatewayStats:
    accepted: int = 0        # streams opened (start event written)
    rejected: int = 0        # 4xx/5xx responses
    completed: int = 0       # streams that reached their done event
    disconnected: int = 0    # client went away mid-stream -> cancel


class SSEGateway:
    """Asyncio HTTP/SSE server over a cluster/frontend.

    ``autostep=True`` (default) runs the pump as a background task;
    ``autostep=False`` leaves stepping to the caller
    (``pump_until_idle``) for deterministic in-process tests."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 autostep: bool = True, seed: int = 0):
        self.cluster = cluster
        self.host = host
        self.port = port
        self.autostep = autostep
        self.seed = seed
        self.stats = GatewayStats()
        self._accepting = True
        self._queues: dict[int, asyncio.Queue] = {}
        self._reqs: dict[int, Request] = {}
        self._live: set[int] = set()
        self._next_rid = 0
        self._wake: Optional[asyncio.Event] = None
        self._server = None
        self._pump_task = None
        self._conns: set = set()

    # ------------------------------ lifecycle --------------------------- #
    async def start(self) -> "SSEGateway":
        self._wake = asyncio.Event()
        self._hook()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.autostep:
            self._pump_task = asyncio.create_task(self._pump())
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def shutdown(self, drain: bool = True, max_steps: int = 100_000
                       ) -> None:
        """Stop intake, then (``drain=True``) keep pumping until every
        accepted stream has delivered its done event — the graceful
        SIGINT path.  ``drain=False`` cancels open streams instead."""
        # connections the kernel accepted while the pump was inside a
        # long engine step are still waiting for their handler task;
        # yield briefly so they reach _handle_conn (and submit) before
        # intake stops, instead of being reset by the listener close
        await asyncio.sleep(0.05)
        self._accepting = False
        if self._server is not None:
            # stop listening now, but wait for the server to close only
            # after the drain below: since Python 3.12.1 ``wait_closed``
            # also waits for every open connection, so awaiting it here
            # would wait forever on the very streams the drain completes
            self._server.close()
        if drain:
            for _ in range(max_steps):
                if not self._live and self.cluster.idle:
                    break
                if not self.autostep and not self.cluster.idle:
                    self._hook()
                    self.cluster.step()
                self._wake.set()
                await asyncio.sleep(0.002)
        else:
            for rid in list(self._live):
                self._disconnect(rid)
        # handler tasks may still be flushing their final SSE frames;
        # wait for them (each closes its transport in its finally) so
        # no bytes are lost if the caller tears the event loop down
        # right after shutdown returns
        conns = {t for t in self._conns if not t.done()}
        if conns:
            await asyncio.wait(conns, timeout=10.0)
        if self._server is not None:
            await self._server.wait_closed()
        if self._pump_task is not None:
            self._pump_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._pump_task
            self._pump_task = None

    # -------------------------------- pump ------------------------------ #
    async def _pump(self) -> None:
        """Background step loop: drive the cluster while any replica has
        work; park on the wake event when idle (submits set it)."""
        while True:
            if self.cluster.idle:
                self._wake.clear()
                # woken by a submit, a drain request, or shutdown
                await self._wake.wait()
                continue
            self._hook()
            self.cluster.step()
            await asyncio.sleep(0)       # let handlers flush SSE frames

    async def pump_until_idle(self, max_steps: int = 10_000) -> int:
        """Manual pump for ``autostep=False`` tests; returns steps run."""
        n = 0
        for _ in range(max_steps):
            if self.cluster.idle:
                break
            self._hook()
            self.cluster.step()
            n += 1
            await asyncio.sleep(0)
        return n

    def _hook(self) -> None:
        # (re)install the terminal-outcome hook on every driver — cheap,
        # and it keeps autoscaler-grown or drain-migration-target drivers
        # wired without the gateway tracking pool membership
        for d in self.cluster.drivers:
            if d.on_finish is not self._on_finish:
                d.on_finish = self._on_finish

    # ----------------------------- callbacks ---------------------------- #
    def _on_token(self, rid: int, toks: list) -> None:
        q = self._queues.get(rid)
        if q is not None:
            q.put_nowait(("token", {"tokens": [int(t) for t in toks]}))

    def _on_finish(self, req: Request, attained: bool, dropped: bool
                   ) -> None:
        q = self._queues.get(req.rid)
        if q is not None:
            t = req.finish_time
            q.put_nowait(("done", {
                "attained": bool(attained), "dropped": bool(dropped),
                "t": None if t is None else round(t, 6)}))

    def _disconnect(self, rid: int) -> None:
        """Client went away mid-stream: cancel the request so its pages
        and slot free immediately (budget conservation holds)."""
        q = self._queues.pop(rid, None)
        self._reqs.pop(rid, None)
        self._live.discard(rid)
        self.cluster.cancel(rid)
        self.stats.disconnected += 1
        if q is not None:
            # wake the stream relay if it is parked on the queue (the
            # shutdown(drain=False) path disconnects from outside the
            # handler task); harmless when the relay itself called us
            q.put_nowait(("close", {}))

    # ---------------------------- HTTP server --------------------------- #
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve_conn(reader, writer)
        finally:
            self._conns.discard(task)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await _read_request(reader)
        except (asyncio.IncompleteReadError, ValueError, ConnectionError):
            writer.close()
            return
        try:
            if method == "POST" and path == "/v1/generate":
                await self._handle_generate(reader, writer, body)
            elif method == "GET" and path == "/metrics":
                await _respond(writer, 200, self._metrics_text(),
                               ctype="text/plain; version=0.0.4")
            elif method == "GET" and path == "/healthz":
                await _respond(writer, 200, json.dumps(
                    {"ok": True, "accepting": self._accepting},
                    sort_keys=True))
            elif method == "POST" and path == "/admin/drain":
                await self._handle_drain(writer, body)
            else:
                self.stats.rejected += 1
                await _respond(writer, 404, '{"error":"not found"}')
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _handle_generate(self, reader, writer, body: bytes) -> None:
        if not self._accepting:
            self.stats.rejected += 1
            await _respond(writer, 503, '{"error":"shutting down"}')
            return
        rid = self._next_rid
        try:
            payload = json.loads(body.decode() or "{}")
            req, prompt = request_from_payload(
                payload, rid, arrival=float(self.cluster.clock))
        except (PayloadError, json.JSONDecodeError, UnicodeDecodeError,
                TypeError) as e:
            self.stats.rejected += 1
            await _respond(writer, 400, json.dumps({"error": str(e)}))
            return
        self._next_rid = rid + 1
        if prompt is None:
            # deterministic per-rid prompt (independent of which replica
            # serves the request, unlike the driver's own rng fallback)
            vocab = self.cluster.drivers[0].engine.cfg.vocab
            rng = np.random.default_rng((self.seed, rid))
            prompt = rng.integers(1, vocab, req.stages[0].length).tolist()
        q: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = q
        self._reqs[rid] = req
        self._live.add(rid)
        self._hook()
        self.cluster.submit(req, prompt=prompt, on_token=self._on_token)
        self._wake.set()
        self.stats.accepted += 1
        try:
            await _write_head(writer, 200, sse=True)
            await _write_event(writer, "start", {
                "rid": rid, "slo_class": slo_class_of(req)})
            await self._stream(reader, writer, rid, q)
        except ConnectionError:
            if rid in self._live:
                self._disconnect(rid)
        finally:
            self._queues.pop(rid, None)
            self._reqs.pop(rid, None)
            self._live.discard(rid)

    async def _stream(self, reader, writer, rid: int,
                      q: asyncio.Queue) -> None:
        """Relay queued events to the client until done; a client EOF
        before done cancels the request server-side."""
        monitor = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, monitor},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await getter
                    self._disconnect(rid)
                    return
                ev, data = getter.result()
                if ev == "close":      # server-side disconnect sentinel
                    return
                await _write_event(writer, ev, data)
                if ev == "done":
                    self.stats.completed += 1
                    self._live.discard(rid)
                    return
        finally:
            if not monitor.done():
                monitor.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await monitor

    async def _handle_drain(self, writer, body: bytes) -> None:
        try:
            idx = int(json.loads(body.decode() or "{}").get("replica", -1))
            self.cluster.drain_replica(idx)
        except (AttributeError, IndexError, RuntimeError, ValueError,
                json.JSONDecodeError) as e:
            self.stats.rejected += 1
            await _respond(writer, 400, json.dumps({"error": str(e)}))
            return
        self._wake.set()                 # migration work needs pumping
        await _respond(writer, 200, json.dumps({"draining": idx}))

    def _metrics_text(self) -> str:
        tel = getattr(self.cluster, "telemetry", None)
        if tel is None or not tel.enabled:
            return "# telemetry disabled (REPRO_METRICS=0)\n"
        from repro_torch.telemetry.exporters import timeseries_prometheus_text
        return tel.prometheus() + timeseries_prometheus_text(tel.sampler)


# ------------------------- HTTP/SSE wire helpers ------------------------ #
async def _read_request(reader) -> tuple[str, str, bytes]:
    head = await reader.readuntil(b"\r\n\r\n")
    if len(head) > _MAX_HEADER:
        raise ValueError("headers too large")
    lines = head.decode("latin1").split("\r\n")
    method, path, _ = lines[0].split(" ", 2)
    clen = 0
    for ln in lines[1:]:
        if ln.lower().startswith("content-length:"):
            clen = int(ln.split(":", 1)[1].strip())
    if clen > _MAX_BODY:
        raise ValueError("body too large")
    body = await reader.readexactly(clen) if clen else b""
    return method, path, body


async def _write_head(writer, status: int, sse: bool = False,
                      ctype: str = "application/json",
                      extra: str = "") -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              503: "Service Unavailable"}.get(status, "OK")
    if sse:
        ctype = "text/event-stream"
        extra = "Cache-Control: no-cache\r\n"
    writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                  f"Content-Type: {ctype}\r\n{extra}"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()


async def _respond(writer, status: int, body: str,
                   ctype: str = "application/json") -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              503: "Service Unavailable"}.get(status, "OK")
    data = body.encode()
    writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                  f"Content-Type: {ctype}\r\n"
                  f"Content-Length: {len(data)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + data)
    await writer.drain()


async def _write_event(writer, event: str, data: dict) -> None:
    # deterministic framing: sorted keys, compact separators, virtual
    # times only — stream bytes must be reproducible and invariant to
    # telemetry on/off (tests/test_gateway.py)
    payload = json.dumps(data, sort_keys=True, separators=(",", ":"))
    writer.write(f"event: {event}\ndata: {payload}\n\n".encode())
    await writer.drain()


# ------------------------------ SSE client ------------------------------ #
class GatewayClientError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


async def open_sse(host: str, port: int, payload: dict,
                   path: str = "/v1/generate"):
    """POST ``payload`` and return ``(reader, writer)`` positioned at the
    start of the SSE event stream.  Raises ``GatewayClientError`` on a
    non-200 response.  Close the writer mid-stream to disconnect (the
    server cancels the request)."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    status, rest = await _read_response_head(reader)
    if status != 200:
        text = rest + (await reader.read())
        writer.close()
        raise GatewayClientError(status, text.decode(errors="replace"))
    return reader, writer


async def _read_response_head(reader) -> tuple[int, bytes]:
    head = await reader.readuntil(b"\r\n\r\n")
    status = int(head.decode("latin1").split("\r\n")[0].split(" ")[1])
    return status, b""


async def sse_events(reader):
    """Async generator over ``(event, data_dict)`` SSE frames; ends at
    server close."""
    buf = b""
    while True:
        chunk = await reader.read(4096)
        if not chunk:
            return
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            event, data = "message", None
            for line in frame.decode().splitlines():
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
            yield event, data


async def http_get(host: str, port: int, path: str) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()
    status, _ = await _read_response_head(reader)
    body = await reader.read()
    writer.close()
    return status, body.decode(errors="replace")


async def http_post(host: str, port: int, path: str, payload: dict
                    ) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    status, _ = await _read_response_head(reader)
    text = await reader.read()
    writer.close()
    return status, text.decode(errors="replace")


async def collect_stream(host: str, port: int, payload: dict
                         ) -> dict:
    """Convenience client: POST, consume the full stream, and return
    ``{"rid", "slo_class", "chunks", "tokens", "done"}``."""
    reader, writer = await open_sse(host, port, payload)
    out = {"rid": None, "slo_class": None, "chunks": [], "tokens": [],
           "done": None}
    try:
        async for ev, data in sse_events(reader):
            if ev == "start":
                out["rid"] = data["rid"]
                out["slo_class"] = data["slo_class"]
            elif ev == "token":
                out["chunks"].append(list(data["tokens"]))
                out["tokens"].extend(data["tokens"])
            elif ev == "done":
                out["done"] = data
                break
    finally:
        writer.close()
    return out


# --------------------------- threaded harness --------------------------- #
class GatewayHandle:
    """A gateway running on its own event loop in a daemon thread —
    real TCP between a blocking engine pump and open-loop asyncio
    clients on the caller's thread (``chip_smoke.py``'s live replay)."""

    def __init__(self, gateway: SSEGateway, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.gateway = gateway
        self.loop = loop
        self.thread = thread

    @property
    def host(self) -> str:
        return self.gateway.host

    @property
    def port(self) -> int:
        return self.gateway.port

    @property
    def url(self) -> str:
        return self.gateway.url

    def shutdown(self, drain: bool = True, timeout: float = 120.0) -> None:
        fut = asyncio.run_coroutine_threadsafe(
            self.gateway.shutdown(drain=drain), self.loop)
        fut.result(timeout)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout)


def _bind_engine_device(cluster) -> None:
    """Make the engines' CUDA device current on the calling thread (the
    current device and stream are per thread; a new thread starts on
    device 0 and its default stream).  Nothing to do on the CPU, and
    ``torch`` is imported only when an engine lives on a card."""
    dev = getattr(cluster.drivers[0].engine, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev)


def run_in_thread(cluster, host: str = "127.0.0.1", port: int = 0,
                  seed: int = 0) -> GatewayHandle:
    """Start an ``SSEGateway`` over ``cluster`` on a dedicated thread and
    block until it accepts connections.  Build the cluster before, and
    let only this thread step it: the caller's thread must not touch an
    engine tensor while the gateway runs."""
    started = threading.Event()
    box: dict = {}

    def runner():
        _bind_engine_device(cluster)
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        gw = SSEGateway(cluster, host=host, port=port, seed=seed)
        loop.run_until_complete(gw.start())
        box["gw"], box["loop"] = gw, loop
        started.set()
        loop.run_forever()
        loop.close()

    t = threading.Thread(target=runner, daemon=True,
                         name="sse-gateway")
    t.start()
    started.wait()
    return GatewayHandle(box["gw"], box["loop"], t)
