"""Asyncio streaming frontend over the continuous-batching engine (a copy
of ``repro.serving.frontend``; stdlib only).

The engine is not thread-safe, and everything it owns (scheduler, pool,
the overlapped pipeline's in-flight record) is mutated only by its own
**engine thread** (:class:`EngineLoop`).  The asyncio HTTP server never
touches the engine: every control-plane operation (submit, cancel,
shutdown) is a closure queued on a thread-safe inbox that the engine
thread drains **at tick boundaries**, never while a tick is mid-flight.
That rule carries the lifecycle guarantees over to the overlapped engine:

* a submit that must be shed runs on the engine thread between ticks, so
  shedding never races the in-flight dispatch;
* a cancel lands at a tick boundary and flows through the engine's abort
  path; the overlapped commit (:meth:`ContinuousEngine._sync_inflight`)
  re-checks ``(slot, rid)``, so the cancelled request's dispatched window
  is dropped, never committed;
* deadline expiry runs at tick start inside the engine.

The engine thread is not the thread the engine was built on.  On CUDA the
engine runs every device call on its own device and stream whichever
thread makes it (``ContinuousEngine._on_stream``), so its replays, pinned
copies, sampler and token read stay on the stream its graphs were captured
and synced against.

Token streaming flows the other way, engine thread -> event loop: the
per-request ``on_token`` callback hands each :class:`RequestOutput`
snapshot to the request's ``asyncio.Queue`` through
``loop.call_soon_threadsafe``.

**Errors surface.**  An exception in the engine thread (a failed kernel
launch, a device error) is stored in :attr:`EngineLoop.error`; the server
then answers every open stream with a terminal ``"error"`` frame, stops
accepting requests and shuts down, and :meth:`ServerFrontend.run` raises
it.  A dead engine never leaves the server serving.

HTTP surface (HTTP/1.1, newline-delimited JSON over chunked transfer
encoding for streams):

* ``POST /v1/generate`` — body ``{"prompt": [ids...], "max_new_tokens":
  n, "temperature": t, "top_k": k, "top_p": p, "seed": s,
  "deadline_s": d, "ttft_deadline_s": d2}`` (all but ``prompt``
  optional).  Streams one JSON line per committed token window:
  ``{"request_id", "tokens": [new ids], "finished", "finish_reason"}``.
* ``POST /v1/cancel`` — body ``{"request_id": n}``; replies
  ``{"cancelled": bool}``.
* ``GET /healthz`` — liveness + tick counter.
* ``POST /v1/shutdown`` — clean shutdown: stop admitting, drain the
  engine thread (which quiesces the overlapped pipeline), then stop the
  server.
"""
from __future__ import annotations

import asyncio
import json
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

from .sampling import SamplingParams

_PARAM_FIELDS = ("temperature", "top_k", "top_p", "seed",
                 "max_new_tokens", "eos_id", "deadline_s",
                 "ttft_deadline_s")


def params_from_json(body: Dict[str, Any]) -> SamplingParams:
    """Build :class:`SamplingParams` from a request body, accepting only
    the whitelisted scalar fields (unknown keys are ignored so clients
    can version forward; ``stop_ids`` is deliberately excluded — token-id
    tuples over JSON invite type confusion and nothing serves them yet).
    """
    kw = {f: body[f] for f in _PARAM_FIELDS if body.get(f) is not None}
    return SamplingParams(**kw)


class EngineLoop:
    """The engine thread: ticks the engine, draining inbox ops at every
    tick boundary.

    ``post(op)`` is callable from any thread; ``op`` runs on the engine
    thread between ticks.  ``stop()`` asks the loop to exit — it drains
    the remaining ops, quiesces the engine (committing or discarding the
    overlapped pipeline's in-flight tick), and returns.  An exception in
    the loop is stored in :attr:`error`, handed to ``on_error`` and
    raised again.
    """

    def __init__(self, engine, idle_wait: float = 0.002,
                 on_error: Optional[Callable[[BaseException], None]] = None):
        self.engine = engine
        self.idle_wait = idle_wait
        self.on_error = on_error
        self.ticks = 0
        self._ops: Deque[Callable[[], None]] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None

    def post(self, op: Callable[[], None]) -> None:
        with self._lock:
            self._ops.append(op)
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def run(self) -> None:
        eng = self.engine
        try:
            while True:
                with self._lock:
                    ops = list(self._ops)
                    self._ops.clear()
                for op in ops:
                    op()
                if self._stop.is_set():
                    break
                sch = eng.scheduler
                if sch.done():
                    self._wake.wait(self.idle_wait)
                    self._wake.clear()
                    continue
                if (not sch.active and sch.queue
                        and min(r.next_admit for r in sch.queue)
                        > sch.clock()):
                    # whole queue backing off (paged deferral): sleep the
                    # shortest backoff instead of hot-spinning ticks
                    self._wake.wait(self.idle_wait)
                    self._wake.clear()
                eng.step()
                self.ticks += 1
            eng.quiesce()
        except BaseException as e:     # surfaced by the frontend on join
            self.error = e
            if self.on_error is not None:
                self.on_error(e)
            raise


class ServerFrontend:
    """Asyncio HTTP server bridging clients to one :class:`EngineLoop`.

    ``run()`` blocks the calling thread inside ``asyncio.run`` until
    shutdown; ``shutdown()`` is thread-safe.  ``ready`` (if given) is
    called on the event loop with the bound port once the socket is
    listening — tests use it to rendezvous, ``launch/serve --server``
    prints the URL from it.  If the engine thread dies, every open stream
    gets a terminal ``"error"`` frame, the server shuts down and ``run()``
    raises the engine's error.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 on_shutdown: Optional[Callable[[], None]] = None):
        self.host = host
        self.port = port                     # rebound to the real port
        self.loop_thread = EngineLoop(engine, on_error=self._engine_died)
        self._on_shutdown = on_shutdown
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown = threading.Event()
        self.requests_served = 0
        # what waits on the engine thread (stream queues, reply futures),
        # failed together if it dies; touched on the event loop only
        self._waiting: set = set()
        self._dead: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------
    def run(self, ready: Optional[Callable[[int], None]] = None) -> None:
        asyncio.run(self._amain(ready))
        if self.loop_thread.error is not None:
            raise RuntimeError("engine thread died") \
                from self.loop_thread.error

    def shutdown(self) -> None:
        """Request a clean shutdown from any thread."""
        self._shutdown.set()
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(self._shutdown_evt.set)

    def _engine_died(self, err: BaseException) -> None:
        """Engine thread: hand its error to the event loop."""
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(self._fail_waiting, err)

    def _fail_waiting(self, err: BaseException) -> None:
        """Event loop: end every open stream and pending reply with the
        engine's error, then shut the server down."""
        self._dead = err
        for w in list(self._waiting):
            if isinstance(w, asyncio.Queue):
                w.put_nowait(err)
            elif not w.done():
                w.set_exception(RuntimeError(f"engine thread died: {err!r}"))
        self._shutdown_evt.set()

    def _engine_reply(self, compute: Callable[[], Any]) -> asyncio.Future:
        """Run ``compute`` on the engine thread at a tick boundary; the
        future resolves to its result (or fails if the engine dies)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._waiting.add(fut)
        fut.add_done_callback(self._waiting.discard)

        def op():
            value = compute()
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(value))
        if self._dead is not None:
            fut.set_exception(RuntimeError(
                f"engine thread died: {self._dead!r}"))
        else:
            self.loop_thread.post(op)
        return fut

    async def _amain(self, ready) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown_evt = asyncio.Event()
        if self._shutdown.is_set():          # shutdown() beat run()
            self._shutdown_evt.set()
        engine_thread = threading.Thread(
            target=self.loop_thread.run, name="engine-loop", daemon=True)
        engine_thread.start()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if ready is not None:
            ready(self.port)
        try:
            await self._shutdown_evt.wait()
        finally:
            server.close()
            await server.wait_closed()
            # drain the engine thread off the event loop: it finishes the
            # ops already posted, quiesces the pipeline, then exits
            self.loop_thread.stop()
            await asyncio.get_running_loop().run_in_executor(
                None, engine_thread.join)
            if self._on_shutdown is not None:
                self._on_shutdown()

    # -- HTTP plumbing ------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, target, body = await self._read_request(reader)
            if method is None:
                return
            if method == "POST" and target == "/v1/generate":
                await self._generate(writer, body)
            elif method == "POST" and target == "/v1/cancel":
                await self._cancel(writer, body)
            elif method == "GET" and target == "/healthz":
                lt = self.loop_thread
                await self._json(writer, 200, {
                    "ok": lt.error is None, "ticks": lt.ticks,
                    "requests_served": self.requests_served})
            elif method == "POST" and target == "/v1/shutdown":
                await self._json(writer, 200, {"shutting_down": True})
                self._shutdown_evt.set()
            else:
                await self._json(writer, 404, {"error": "not found"})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line:
            return None, None, None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None, None, None
        method, target = parts[0], parts[1]
        length = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = int(val.strip())
        raw = await reader.readexactly(length) if length else b""
        try:
            body = json.loads(raw) if raw else {}
        except ValueError:
            body = None
        return method, target, body

    @staticmethod
    async def _json(writer, status: int, obj: Dict[str, Any]) -> None:
        payload = (json.dumps(obj) + "\n").encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  503: "Service Unavailable"}.get(status, "OK")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n".encode() + payload)
        await writer.drain()

    # -- endpoints ----------------------------------------------------------
    async def _generate(self, writer, body) -> None:
        if (not isinstance(body, dict) or "prompt" not in body
                or not isinstance(body["prompt"], list)):
            await self._json(writer, 400,
                             {"error": "body must be JSON with a "
                                       "'prompt' token-id list"})
            return
        try:
            params = params_from_json(body)
            prompt = [int(t) for t in body["prompt"]]
        except (TypeError, ValueError) as e:
            await self._json(writer, 400, {"error": str(e)})
            return
        loop = asyncio.get_running_loop()
        snapshots: asyncio.Queue = asyncio.Queue()

        def on_token(out):
            loop.call_soon_threadsafe(snapshots.put_nowait, out)

        # engine thread, tick boundary: submit + register streaming.  A
        # shed fires on_token synchronously in there — the snapshot is
        # queued before the rid resolves, so the client always sees its
        # terminal frame.
        self._waiting.add(snapshots)
        try:
            rid = await self._engine_reply(
                lambda: self.loop_thread.engine.submit(prompt, params,
                                                       on_token=on_token))
        except RuntimeError as e:
            self._waiting.discard(snapshots)
            await self._json(writer, 503, {"error": str(e)})
            return
        self.requests_served += 1
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: close\r\n\r\n")
        sent = 0
        try:
            while True:
                out = await snapshots.get()
                if isinstance(out, BaseException):
                    frame = {"request_id": rid, "tokens": [],
                             "finished": True, "finish_reason": "error",
                             "error": repr(out)}
                    data = (json.dumps(frame) + "\n").encode()
                    writer.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                    break
                frame = {"request_id": rid,
                         "tokens": list(out.token_ids[sent:]),
                         "finished": out.finished,
                         "finish_reason": out.finish_reason}
                sent = len(out.token_ids)
                data = (json.dumps(frame) + "\n").encode()
                writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                await writer.drain()
                if out.finished:
                    break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionError, OSError):
            # client went away mid-stream: cancel through the inbox so
            # the abort lands at a tick boundary like any other cancel
            self.loop_thread.post(
                lambda: self.loop_thread.engine.cancel(rid))
        finally:
            self._waiting.discard(snapshots)

    async def _cancel(self, writer, body) -> None:
        if not isinstance(body, dict) or "request_id" not in body:
            await self._json(writer, 400,
                             {"error": "body must carry 'request_id'"})
            return
        rid = int(body["request_id"])
        try:
            done = await self._engine_reply(
                lambda: self.loop_thread.engine.cancel(rid))
        except RuntimeError as e:
            await self._json(writer, 503, {"error": str(e)})
            return
        await self._json(writer, 200, {"cancelled": bool(done)})
