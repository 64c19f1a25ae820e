"""``repro_torch.serving.gateway`` — async API front door for the engine
(port of the JAX package's ``serving/gateway.py``).

A stdlib-only asyncio HTTP/1.1 server (hand-rolled request parsing, same
no-dependency stance as ``repro_torch.obs.metrics.serve_metrics``) that
owns the engine loop in a background thread and exposes:

* ``POST /v1/generate`` — submit a prompt.  ``"stream": true`` returns
  Server-Sent Events over chunked transfer encoding (one ``data:`` event
  per token, a final event with ``done``/``finish_reason``/``usage``,
  then ``data: [DONE]``); without it the response is one JSON body.
  Requests carry ``priority`` (``interactive``/``standard``/
  ``best_effort``), ``tenant`` and ``queue_deadline_s``; the engine's
  admission control maps to HTTP: queue-full backpressure → **429** with
  ``Retry-After``, a missed queue-wait deadline → **504**, validation
  errors → **400**, draining → **503**.
* ``GET /v1/health`` — liveness + load (queue depth, occupancy,
  suspended count, rung).
* ``GET /metrics`` — the engine's Prometheus text exposition
  (``repro_torch.obs.metrics.engine_exposition``).
* ``GET /v1/debug/flight`` — the flight recorder's ring contents and
  counters, plus a triggered dump when the recorder has a dump dir
  (``repro_torch.obs.flight``); 404 without a recorder.

On every route both packages serve, bodies, status codes and headers
are the reference's, byte for byte.

Threading model: exactly one background thread touches the engine and
the card — it drains a thread-safe submission queue, then calls
``engine.step()`` (admission, preemption and token emission all happen
there).  HTTP handlers never call into the engine for generation; they
hand a submission to the engine thread and receive per-token/finish
events back through ``loop.call_soon_threadsafe`` onto a per-request
asyncio queue.  ``/v1/health`` and ``/metrics`` read Python counters
cross-thread without locking (torn reads of monotonically increasing
stats are acceptable for observability) and never touch a tensor: a
device read from the HTTP thread would stall the loop or break a graph
capture running at the same time.

On the card the CUDA graphs are built before the gateway accepts a
connection (the constructor runs ``Engine.warmup()`` on an engine not
warmed yet) and replayed from the engine thread.  The current device,
stream and grad mode are per thread in PyTorch, so the engine thread
sets the engine's device, runs under ``torch.no_grad()`` and refuses to
run on any stream but the default one, which is where the engine's
steps and copies are ordered.

An exception on the engine thread is not swallowed: it is kept on
:attr:`Gateway.error`, every request still waiting gets **500**, the
gateway drains, the exception propagates out of the thread (so
``threading.excepthook`` sees it) and :meth:`Gateway.serve_forever` /
:meth:`Gateway.stop` raise.

Graceful drain: SIGTERM/SIGINT (or :meth:`Gateway.stop`) stops
accepting connections, lets in-flight requests finish (the engine keeps
stepping until idle), then joins the engine thread and calls
``engine.close()`` so telemetry sinks flush.  Exit is clean: the serve
CLI exits 0 after SIGTERM.
"""
from __future__ import annotations

import asyncio
import json
import queue
import signal
import threading
from typing import Any, Callable, Dict, Optional, Set, Tuple

import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.request import FinishReason, Priority, RequestState
from repro_torch.serving.scheduler import QueueFull

_MAX_HEADER = 64 * 1024
_MAX_BODY = 1 << 20
_REQUEST_TIMEOUT_S = 30.0


class _Pending:
    """One generate call's bridge from the engine thread back to its
    HTTP handler: engine-side callbacks post ``("token", t)`` /
    ``("finish", info)`` / ``("reject", retry_after, msg)`` /
    ``("error", msg)`` / ``("fail", msg)`` (the engine thread died)
    items onto an asyncio queue via ``call_soon_threadsafe``."""

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 payload: Dict[str, Any]):
        self.loop = loop
        self.payload = payload
        self.events: asyncio.Queue = asyncio.Queue()

    def post(self, item: Tuple) -> None:
        self.loop.call_soon_threadsafe(self.events.put_nowait, item)


def _finish_info(rs: RequestState) -> Dict[str, Any]:
    return {
        "finish_reason": rs.finish_reason.value
        if rs.finish_reason is not None else None,
        "usage": {
            "prompt_tokens": rs.request.prompt_len,
            "completion_tokens": len(rs.tokens),
        },
        "preemptions": rs.preemptions,
    }


class Gateway:
    """HTTP front door over one
    :class:`~repro_torch.serving.engine.Engine`.

    Two driving modes:

    * :meth:`serve_forever` — blocking; installs SIGTERM/SIGINT drain
      handlers (CLI mode, ``repro_torch.launch.serve --gateway``).
    * :meth:`start` / :meth:`stop` — background-thread mode for tests
      and embedding; ``start`` returns the bound port.

    The constructor builds every step of an engine not warmed yet
    (``Engine.warmup()``, which needs an idle engine)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0):
        if engine.decode_retraces_after_warmup is None:
            engine.warmup()
        self.engine = engine
        # the card the engine's steps were built on ("cuda" names the
        # constructing thread's current device)
        dev = engine.device
        self._cuda_index: Optional[int] = None
        if dev.type == "cuda":
            self._cuda_index = torch.cuda.current_device() \
                if dev.index is None else dev.index
        # the engine thread's exception, if it died (see the docstring)
        self.error: Optional[BaseException] = None
        # engine thread only: the submitted requests not finished yet
        self._live: Set[_Pending] = set()
        # called with the bound port once connections are accepted
        self.on_ready: Optional[Callable[[int], None]] = None
        self.host = host
        self.port = port                      # 0 = ephemeral; rebound at start
        self._submits: queue.Queue = queue.Queue()
        self._wake = threading.Event()        # engine thread idle-park
        self._stop_engine = threading.Event()
        self._draining = False
        self._inflight = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._drain_requested: Optional[asyncio.Event] = None
        self._started = threading.Event()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="gateway-engine", daemon=True)
        self._serve_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        eng = self.engine
        try:
            with torch.no_grad():
                if self._cuda_index is not None:
                    # device and stream are per thread: replay where the
                    # engine's steps and copies are ordered
                    torch.cuda.set_device(self._cuda_index)
                    if torch.cuda.current_stream() != \
                            torch.cuda.default_stream():
                        raise RuntimeError(
                            "the gateway's engine thread must run on the "
                            "device's default stream")
                while True:
                    while True:
                        try:
                            pending = self._submits.get_nowait()
                        except queue.Empty:
                            break
                        self._submit_one(pending)
                    if eng.scheduler.has_work():
                        eng.step()
                    elif self._stop_engine.is_set():
                        return
                    else:
                        self._wake.wait(timeout=0.02)
                        self._wake.clear()
        except BaseException as e:
            self._fail(e)
            raise

    def _fail(self, exc: BaseException) -> None:
        """The engine thread died: keep the exception, answer every
        waiting request with 500 and start the drain."""
        self.error = exc
        msg = f"engine thread failed: {type(exc).__name__}: {exc}"
        for pending in list(self._live):
            pending.post(("fail", msg))
        self._live.clear()
        self._fail_queued()
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self.begin_drain)

    def _fail_queued(self) -> None:
        msg = f"engine thread failed: {self.error!r}"
        while True:
            try:
                self._submits.get_nowait().post(("fail", msg))
            except queue.Empty:
                return

    def _submit_one(self, pending: _Pending) -> None:
        p = pending.payload

        def on_finish(rs):
            self._live.discard(pending)
            pending.post(("finish", _finish_info(rs)))
        try:
            self.engine.submit(
                p["prompt"], p["max_new_tokens"], eos_id=p.get("eos_id"),
                priority=p.get("priority", Priority.STANDARD),
                tenant=p.get("tenant", "default"),
                queue_deadline_s=p.get("queue_deadline_s"),
                on_token=lambda _rid, tok: pending.post(("token", tok)),
                on_finish=on_finish)
        except QueueFull as e:
            pending.post(("reject", e.retry_after, str(e)))
            return
        except (ValueError, TypeError, RuntimeError) as e:
            pending.post(("error", str(e)))
            return
        self._live.add(pending)

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        head = await reader.readuntil(b"\r\n\r\n")
        if len(head) > _MAX_HEADER:
            raise ValueError("header block too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            raise ValueError(f"malformed request line {lines[0]!r}") from None
        headers = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", "0") or "0")
        if n:
            if n > _MAX_BODY:
                raise ValueError(f"body of {n} bytes exceeds {_MAX_BODY}")
            body = await reader.readexactly(n)
        return method.upper(), target, headers, body

    @staticmethod
    def _response(status: int, reason: str, body: bytes,
                  content_type: str = "application/json",
                  extra: Tuple[Tuple[str, str], ...] = ()) -> bytes:
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        head.extend(f"{k}: {v}" for k, v in extra)
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body

    @classmethod
    def _json_response(cls, status: int, reason: str, obj,
                       extra: Tuple[Tuple[str, str], ...] = ()) -> bytes:
        return cls._response(
            status, reason, (json.dumps(obj) + "\n").encode(), extra=extra)

    @staticmethod
    async def _write_chunk(writer: asyncio.StreamWriter, data: bytes) -> None:
        writer.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        await writer.drain()

    @staticmethod
    def _sse(obj) -> bytes:
        return f"data: {json.dumps(obj)}\n\n".encode()

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, target, headers, body = await asyncio.wait_for(
                    self._read_request(reader), timeout=_REQUEST_TIMEOUT_S)
            except (ValueError, asyncio.IncompleteReadError,
                    asyncio.LimitOverrunError, asyncio.TimeoutError) as e:
                writer.write(self._json_response(
                    400, "Bad Request", {"error": str(e)}))
                await writer.drain()
                return
            path = target.split("?", 1)[0]
            if method == "GET" and path == "/v1/health":
                writer.write(self._json_response(
                    200, "OK", self._health()))
                await writer.drain()
            elif method == "GET" and path == "/metrics":
                writer.write(self._response(
                    200, "OK", self.engine.metrics_exposition().encode(),
                    content_type="text/plain; version=0.0.4"))
                await writer.drain()
            elif method == "GET" and path == "/v1/debug/flight":
                fr = self.engine.obs.flight
                if fr is None:
                    writer.write(self._json_response(
                        404, "Not Found",
                        {"error": "no flight recorder armed "
                                  "(serve with --flight-record)"}))
                else:
                    # the recorder copies its ring before reading it (the
                    # engine thread appends meanwhile); also a black-box
                    # dump trigger when a dump dir is configured
                    snap = fr.debug_snapshot()
                    dump_path = fr.dump("http")
                    if dump_path is not None:
                        snap["dump_path"] = dump_path
                    writer.write(self._json_response(200, "OK", snap))
                await writer.drain()
            elif method == "POST" and path == "/v1/generate":
                await self._generate(writer, body)
            else:
                writer.write(self._json_response(
                    404, "Not Found",
                    {"error": f"no route for {method} {path}"}))
                await writer.drain()
        except (ConnectionError, BrokenPipeError):
            pass                               # client went away mid-write
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    def _health(self) -> Dict[str, Any]:
        eng = self.engine
        return {
            "status": "draining" if self._draining else "ok",
            "queue_depth": eng.scheduler.queue_depth,
            "occupancy": eng.pool.num_occupied,
            "suspended": len(eng.scheduler.suspended),
            "rung": eng.rung,
        }

    @staticmethod
    def _parse_generate(body: bytes) -> Dict[str, Any]:
        """Validate the request host-side so malformed submissions never
        reach the engine thread.  Raises ValueError (→ 400)."""
        try:
            doc = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"invalid JSON body: {e}") from None
        if not isinstance(doc, dict):
            raise ValueError("body must be a JSON object")
        prompt = doc.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            raise ValueError('"prompt" must be a non-empty list of token ids')
        max_new = doc.get("max_new_tokens", 16)
        if not isinstance(max_new, int) or isinstance(max_new, bool) \
                or max_new < 1:
            raise ValueError('"max_new_tokens" must be a positive integer')
        out: Dict[str, Any] = {
            "prompt": prompt, "max_new_tokens": max_new,
            "stream": bool(doc.get("stream", False)),
        }
        if doc.get("eos_id") is not None:
            if not isinstance(doc["eos_id"], int):
                raise ValueError('"eos_id" must be an integer')
            out["eos_id"] = doc["eos_id"]
        if doc.get("priority") is not None:
            out["priority"] = Priority.parse(doc["priority"])
        if doc.get("tenant") is not None:
            if not isinstance(doc["tenant"], str) or not doc["tenant"]:
                raise ValueError('"tenant" must be a non-empty string')
            out["tenant"] = doc["tenant"]
        if doc.get("queue_deadline_s") is not None:
            dl = doc["queue_deadline_s"]
            if not isinstance(dl, (int, float)) or isinstance(dl, bool) \
                    or dl <= 0:
                raise ValueError('"queue_deadline_s" must be positive')
            out["queue_deadline_s"] = float(dl)
        return out

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        if self._draining or self.error is not None:
            writer.write(self._json_response(
                503, "Service Unavailable", {"error": "draining"},
                extra=(("Retry-After", "1"),)))
            await writer.drain()
            return
        try:
            payload = self._parse_generate(body)
        except ValueError as e:
            writer.write(self._json_response(
                400, "Bad Request", {"error": str(e)}))
            await writer.drain()
            return
        self._inflight += 1
        try:
            pending = _Pending(asyncio.get_running_loop(), payload)
            self._submits.put(pending)
            self._wake.set()
            if self.error is not None:      # the engine died meanwhile
                self._fail_queued()
            first = await pending.events.get()
            if first[0] == "reject":
                _, retry_after, msg = first
                writer.write(self._json_response(
                    429, "Too Many Requests", {"error": msg},
                    extra=(("Retry-After",
                            str(max(1, round(retry_after)))),)))
                await writer.drain()
                return
            if first[0] == "error":
                writer.write(self._json_response(
                    400, "Bad Request", {"error": first[1]}))
                await writer.drain()
                return
            if first[0] == "fail":
                await self._fail_response(writer, first[1])
                return
            if first[0] == "finish" and \
                    first[1]["finish_reason"] == FinishReason.EXPIRED.value:
                writer.write(self._json_response(
                    504, "Gateway Timeout",
                    {"error": "queue_deadline_exceeded", **first[1]}))
                await writer.drain()
                return
            if payload["stream"]:
                await self._stream_response(writer, first, pending)
            else:
                await self._json_generate_response(writer, first, pending)
        finally:
            self._inflight -= 1

    async def _json_generate_response(self, writer, first, pending) -> None:
        tokens = []
        event = first
        while event[0] == "token":
            tokens.append(event[1])
            event = await pending.events.get()
        if event[0] == "fail":
            await self._fail_response(writer, event[1])
            return
        info = event[1]                        # ("finish", info)
        writer.write(self._json_response(200, "OK", {
            "tokens": tokens, **info}))
        await writer.drain()

    async def _stream_response(self, writer, first, pending) -> None:
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-store\r\n"
                "Transfer-Encoding: chunked\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode("latin-1"))
        await writer.drain()
        event, index = first, 0
        while event[0] == "token":
            await self._write_chunk(
                writer, self._sse({"token": event[1], "index": index}))
            index += 1
            event = await pending.events.get()
        if event[0] == "fail":
            # the status line is out: end the stream with an error event
            await self._write_chunk(writer, self._sse({"error": event[1]}))
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return
        await self._write_chunk(
            writer, self._sse({"done": True, **event[1]}))
        await self._write_chunk(writer, b"data: [DONE]\n\n")
        writer.write(b"0\r\n\r\n")             # chunked terminator
        await writer.drain()

    async def _fail_response(self, writer, msg: str) -> None:
        writer.write(self._json_response(
            500, "Internal Server Error", {"error": msg}))
        await writer.drain()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def begin_drain(self) -> None:
        """Request graceful shutdown (idempotent; loop-thread only — use
        :meth:`stop` from other threads)."""
        self._draining = True
        if self._drain_requested is not None:
            self._drain_requested.set()

    async def _amain(self, install_signals: bool) -> None:
        self._loop = asyncio.get_running_loop()
        self._drain_requested = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._loop.add_signal_handler(sig, self.begin_drain)
        self._engine_thread.start()
        self._started.set()
        if self.on_ready is not None:
            self.on_ready(self.port)
        try:
            await self._drain_requested.wait()
            server.close()                     # stop accepting
            await server.wait_closed()
            while self._inflight > 0:
                await asyncio.sleep(0.01)
            while self._engine_thread.is_alive() and (
                    not self._submits.empty()
                    or self.engine.scheduler.has_work()):
                await asyncio.sleep(0.01)
        finally:
            self._stop_engine.set()
            self._wake.set()
            self._engine_thread.join(timeout=30.0)
            self.engine.close()

    def serve_forever(self) -> None:
        """Run until SIGTERM/SIGINT, then drain gracefully and return
        (main-thread CLI mode).  Raises if the engine thread died."""
        asyncio.run(self._amain(install_signals=True))
        self._raise_engine_error()

    def _raise_engine_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("the gateway's engine thread failed") \
                from self.error

    def start(self, timeout: float = 60.0) -> int:
        """Run the server on a background thread (no signal handlers);
        returns the bound port once accepting connections."""
        self._serve_thread = threading.Thread(
            target=lambda: asyncio.run(self._amain(install_signals=False)),
            name="gateway-serve", daemon=True)
        self._serve_thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("gateway failed to start")
        return self.port

    def stop(self, timeout: float = 60.0) -> None:
        """Thread-safe graceful drain + shutdown for :meth:`start`.
        Raises if the engine thread died."""
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self.begin_drain)
            except RuntimeError:
                pass        # the loop has closed: the gateway drained
                #             already (the engine thread died)
        if self._serve_thread is not None:
            self._serve_thread.join(timeout)
            if self._serve_thread.is_alive():
                raise RuntimeError("gateway did not drain in time")
        self._raise_engine_error()
