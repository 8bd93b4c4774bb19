"""Async HTTP serving front end (stdlib only: ``asyncio`` + hand-rolled
HTTP/1.1).

Port of ``src/repro/serve/server.py`` (copied over the port's
``serve.api``, ``serve.session`` and ``obs.metrics``): it serves either
backend, classification (``classify_session``) or generation
(``generate_session``).

One process, three moving parts:

  * the **event loop** accepts connections, parses requests, and admits
    work through the :class:`~repro_torch.serve.session.ServeSession` facade —
    admission is just ``scheduler.try_submit`` under the scheduler lock,
    so it is safe from the loop thread while the worker steps;
  * one **worker thread** owns every model call: it waits for work,
    optionally lingers ``admit_wait_s`` so a fresh burst fills the whole
    batch (occupancy), then runs ``backend.step()`` — refill + one
    fixed-shape forward/decode — and resolves the finished requests'
    futures back onto the event loop with ``call_soon_threadsafe``;
  * **load shedding**: when the bounded queue is full, ``POST`` returns
    ``429`` with a ``Retry-After`` header computed from live
    backpressure (queue depth x smoothed step time).  Work the scheduler
    has admitted is never dropped — shedding applies only at the front
    door.

Endpoints::

  POST /v1/run      one request  {"image": [[[...]]]} or
                    {"prompt": [...], "max_new_tokens": n} -> JSON result
  POST /v1/stream   {"requests": [...]} -> chunked NDJSON, one line per
                    request *in completion order* (line carries "index")
  GET  /metrics     Prometheus text exposition (scheduler + SLO hists)
  GET  /healthz     liveness + queue/slot occupancy snapshot

The server boots with a warmup request (the serving path runs once
before traffic), so ``trace_count() == 1`` holds under arbitrary
socket-driven concurrency.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time

import numpy as np

from repro_torch.obs.metrics import Meter
from repro_torch.serve.api import Overloaded, Request, Response
from repro_torch.serve.session import ServeSession

__all__ = ["ServingServer"]

_MAX_BODY = 64 * 1024 * 1024


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_request(obj) -> Request:
    if not isinstance(obj, dict):
        raise _HttpError(400, "request must be a JSON object")
    if "image" in obj:
        try:
            image = np.asarray(obj["image"], np.float32)
        except (TypeError, ValueError) as e:
            raise _HttpError(400, f"bad image payload: {e}") from e
        return Request(image=image)
    if "prompt" in obj:
        try:
            prompt = np.asarray(obj["prompt"], np.int32).reshape(-1)
        except (TypeError, ValueError) as e:
            raise _HttpError(400, f"bad prompt payload: {e}") from e
        return Request(
            prompt=prompt,
            max_new_tokens=int(obj.get("max_new_tokens", 32)),
        )
    raise _HttpError(400, "request needs 'image' or 'prompt'")


class ServingServer:
    """Streaming asyncio HTTP server over a :class:`ServeSession`.

    Args:
      session: the serving session (``classify_session`` /
        ``generate_session``); a bare backend is wrapped automatically.
      host/port: bind address; port 0 picks a free port (see
        ``server.address`` after start).
      admit_wait_s: how long the worker lingers for more arrivals when
        the batch is idle and not yet full — trades a few ms of first
        -request latency for near-full occupancy under bursts.
      warmup: run one warmup request at boot (before traffic).
    """

    def __init__(
        self,
        session: ServeSession,
        host: str = "127.0.0.1",
        port: int = 0,
        admit_wait_s: float = 0.004,
        warmup: bool = True,
    ):
        if not isinstance(session, ServeSession):
            session = ServeSession(session)
        self.session = session
        self.host, self.port = host, port
        self.admit_wait_s = admit_wait_s
        self.do_warmup = warmup
        self.address: tuple[str, int] | None = None
        self.completed = 0  # requests finished over HTTP (any endpoint)
        self.meter = Meter()  # sustained completion rate (req/s, windowed)
        self._stop = threading.Event()
        self._work = threading.Condition()
        self._futures: dict[int, tuple[asyncio.Future, asyncio.AbstractEventLoop]] = {}
        self._server: asyncio.AbstractServer | None = None
        self._worker: threading.Thread | None = None
        self._thread: threading.Thread | None = None
        self._thread_loop: asyncio.AbstractEventLoop | None = None

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> tuple[str, int]:
        """Warm the backend, bind the socket, start the worker thread."""
        if self.do_warmup:
            self.session.warmup()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.address = self._server.sockets[0].getsockname()[:2]
        self._worker = threading.Thread(
            target=self._worker_loop, name="serve-worker", daemon=True
        )
        self._worker.start()
        return self.address

    async def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def start_in_thread(self) -> tuple[str, int]:
        """Boot the server on its own event-loop thread; returns the
        bound ``(host, port)``.  Pair with :meth:`shutdown`."""
        ready = threading.Event()
        boot_err: list[BaseException] = []

        def runner():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._thread_loop = loop
            try:
                loop.run_until_complete(self.start())
            except BaseException as e:  # surface boot failures to caller
                boot_err.append(e)
                ready.set()
                return
            ready.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._thread = threading.Thread(
            target=runner, name="serve-http", daemon=True
        )
        self._thread.start()
        ready.wait(timeout=300)
        if boot_err:
            raise boot_err[0]
        if self.address is None:
            raise RuntimeError("server failed to start within timeout")
        return self.address

    def shutdown(self) -> None:
        """Stop a :meth:`start_in_thread` server from any thread."""
        if self._thread_loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(self.stop(), self._thread_loop)
        fut.result(timeout=30)
        self._thread_loop.call_soon_threadsafe(self._thread_loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=30)

    # --------------------------------------------------------------- worker

    def _worker_loop(self) -> None:
        backend = self.session.backend
        sched = backend.scheduler
        while not self._stop.is_set():
            with self._work:
                while not self._stop.is_set() and not backend.has_work():
                    self._work.wait(timeout=0.05)
            if self._stop.is_set():
                return
            # admission batching: if nothing is mid-flight, linger briefly
            # so a burst fills the whole batch before the first step —
            # occupancy over the burst approaches 1 instead of serving the
            # first arrival alone.  Never delays live decode work.
            if self.admit_wait_s > 0 and not sched.live():
                deadline = time.monotonic() + self.admit_wait_s
                while (
                    sched.queued() < sched.batch_slots
                    and time.monotonic() < deadline
                    and not self._stop.is_set()
                ):
                    time.sleep(self.admit_wait_s / 8)
            for req in backend.step():
                self.completed += 1
                self.meter.mark()
                entry = self._futures.pop(id(req), None)
                if entry is not None:
                    fut, loop = entry
                    loop.call_soon_threadsafe(self._resolve, fut, req)

    @staticmethod
    def _resolve(fut: asyncio.Future, req: Request) -> None:
        if not fut.done():
            fut.set_result(req)

    async def _submit(self, req: Request) -> asyncio.Future:
        """Register a completion future, then admit (order matters: the
        worker may finish the request before ``submit`` returns)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._futures[id(req)] = (fut, loop)
        try:
            self.session.submit(req)
        except BaseException:
            self._futures.pop(id(req), None)
            raise
        with self._work:
            self._work.notify()
        return fut

    # ----------------------------------------------------------------- http

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while not self._stop.is_set():
                line = await reader.readline()
                if not line:
                    break
                try:
                    method, path, _version = line.decode("ascii").split()
                except ValueError:
                    await self._plain(writer, 400, "bad request line")
                    break
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", 0) or 0)
                if length > _MAX_BODY:
                    await self._plain(writer, 413, "body too large")
                    break
                body = await reader.readexactly(length) if length else b""
                keep = await self._route(method, path, body, writer)
                if not keep or headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> bool:
        """Dispatch one request; returns whether to keep the connection."""
        if method == "GET" and path == "/healthz":
            sched = self.session.scheduler
            payload = {
                "ok": True,
                "live": len(sched.live()),
                "queued": sched.queued(),
                "batch_slots": sched.batch_slots,
            }
            await self._json(writer, 200, payload)
            return True
        if method == "GET" and path == "/metrics":
            text = (
                self.session.metrics_text().rstrip("\n") + "\n"
                + "\n".join(self.meter.prom_lines("serve_http_requests"))
                + "\n"
            ).encode()
            await self._raw(
                writer, 200, text, "text/plain; version=0.0.4"
            )
            return True
        if method == "POST" and path == "/v1/run":
            return await self._run_one(body, writer)
        if method == "POST" and path == "/v1/stream":
            return await self._run_stream(body, writer)
        await self._plain(writer, 404, f"no route {method} {path}")
        return True

    async def _run_one(self, body: bytes, writer) -> bool:
        try:
            req = _parse_request(self._load_json(body))
            fut = await self._submit(req)
        except _HttpError as e:
            await self._plain(writer, e.status, e.message)
            return True
        except Overloaded as e:
            await self._shed(writer, e)
            return True
        except ValueError as e:
            await self._plain(writer, 400, str(e))
            return True
        req = await fut
        await self._json(writer, 200, req.response().to_json())
        return True

    async def _run_stream(self, body: bytes, writer) -> bool:
        try:
            obj = self._load_json(body)
            items = obj.get("requests") if isinstance(obj, dict) else None
            if not isinstance(items, list) or not items:
                raise _HttpError(400, "body needs a 'requests' list")
            parsed = [_parse_request(o) for o in items]
        except _HttpError as e:
            await self._plain(writer, e.status, e.message)
            return True
        # chunked NDJSON: one line per request, in completion order
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
        )
        index_of = {id(r): i for i, r in enumerate(parsed)}
        waits = []
        for req in parsed:
            try:
                fut = await self._submit(req)
            except Overloaded as e:
                # shed this one; everything already admitted still runs
                line = Response.shed(e.retry_after_s).to_json()
                line["index"] = index_of[id(req)]
                await self._chunk(writer, line)
                continue
            except ValueError as e:
                line = {"ok": False, "error": str(e),
                        "index": index_of[id(req)]}
                await self._chunk(writer, line)
                continue
            waits.append(fut)
        for fut in asyncio.as_completed(waits):
            req = await fut
            line = req.response().to_json()
            line["index"] = index_of[id(req)]
            await self._chunk(writer, line)
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return True

    # -------------------------------------------------------------- replies

    @staticmethod
    def _load_json(body: bytes):
        try:
            return json.loads(body.decode() or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}") from e

    async def _shed(self, writer, e: Overloaded) -> None:
        body = json.dumps(Response.shed(e.retry_after_s).to_json()).encode()
        retry = max(1, math.ceil(e.retry_after_s))
        writer.write(
            b"HTTP/1.1 429 Too Many Requests\r\n"
            b"Content-Type: application/json\r\n"
            + f"Retry-After: {retry}\r\n".encode()
            + f"Content-Length: {len(body)}\r\n\r\n".encode()
            + body
        )
        await writer.drain()

    @staticmethod
    async def _raw(writer, status: int, body: bytes, ctype: str) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large"}.get(status, "Error")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        await writer.drain()

    async def _json(self, writer, status: int, payload: dict) -> None:
        await self._raw(
            writer, status, json.dumps(payload).encode(), "application/json"
        )

    async def _plain(self, writer, status: int, message: str) -> None:
        await self._raw(writer, status, message.encode(), "text/plain")

    @staticmethod
    async def _chunk(writer, payload: dict) -> None:
        data = json.dumps(payload).encode() + b"\n"
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        await writer.drain()
