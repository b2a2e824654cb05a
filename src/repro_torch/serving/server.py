"""Async HTTP front end over ``HashedClassifierEngine`` (a copy of
``repro/serving/server.py`` over the port's engine; standard library and
numpy only).

The network tier that turns the fused scoring engine into a service:
``asyncio`` + hand-rolled HTTP/1.1 (keep-alive, chunked responses), so
images need no framework dependency.  One event loop thread does all
parsing and response writing; the only blocking work — the wait on each
batch's CUDA event and the device→host copy — stays on the batcher's
resolver thread, bridged back with ``asyncio.wrap_future`` over the
engine's ``concurrent.futures`` handles, so a slow batch never stalls
the accept loop.  Work that launches kernels off the batcher (the
mixed-version repair's ``score_docs``, a reload's copies) runs on
executor threads; every launch sits inside ``torch.cuda.device`` of its
replica (the engine's ``_launch``), and nothing here synchronizes the
whole device.

Endpoints:

  * ``POST /score`` — body ``{"docs": [[id, ...], ...]}`` (or a bare
    list of docs) → ``{"scores": [...], "version": ..., "model": ...}``.
    SINGLE-VERSION: every score in one response was produced by the
    same model version.  If a hot-reload lands exactly between the
    micro-batches of one request, the whole request is re-scored
    pinned to one ``WeightSet`` (rare, bounded, and version-exact) —
    a response never mixes versions.
  * ``POST /score_ndjson`` — streaming: body is NDJSON (one JSON doc
    array per line), the response streams one
    ``{"i", "score", "version"}`` line per doc over chunked encoding
    AS EACH resolves — first scores arrive while later docs are still
    queued.  Per-line version echo (a reload may legitimately flip
    versions mid-stream; each score's tag is exact).
  * ``GET /status`` — engine stats snapshot (rolling p50/p95/p99,
    rows/s, per-lane occupancy, ``compile_misses``, per-tenant rows,
    the dedup cache's counters, kernel launch counts),
    admission counters, and ``health``: ``ok`` | ``degraded`` (batcher
    watchdog detected a stalled drain/resolve thread) | ``draining``.
  * ``GET /healthz`` — 200 when ok, 503 when degraded/draining (load-
    balancer probe).
  * ``POST /reload`` — ``{"ckpt_dir": ..., "step"?: ..., "version"?:
    ...}`` → versioned hot swap via ``serving.reload.ReloadManager``;
    404 when no checkpoint is there, 409 when it doesn't match the
    live model; a failed reload never touches the live weights.

Admission & drain (see ``serving.admission``): a request acquires
``len(docs)`` rows of the bounded in-flight budget before any engine
work — beyond the budget it is rejected immediately with 429 +
``Retry-After`` (lanes saturate ⇒ reject fast, never queue unboundedly).
SIGTERM/SIGINT (or ``request_drain()``) triggers graceful drain: new
work is refused with 503, in-flight requests finish and respond, the
engine's ``close()`` flushes every accepted future, then the sockets
close and ``run()`` returns — no request is ever silently dropped.

Per-request rows/latency land in the engine's stats window keyed by an
optional tenant header (default ``X-Tenant``) for per-tenant accounting.
"""
from __future__ import annotations

import asyncio
import http.client
import json
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ft.retry import BackoffPolicy
from repro_torch.serving.admission import (AdmissionController, Draining,
                                           Overloaded)
from repro_torch.serving.reload import ReloadManager

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 64 << 20
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large", 429: "Too Many Requests",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _jsonable(score):
    """Engine result → JSON value (binary margin float or multiclass
    score list)."""
    arr = np.asarray(score)
    if arr.ndim == 0:
        return float(arr)
    return [float(x) for x in arr]


class ScoreServer:
    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 *, admission: Optional[AdmissionController] = None,
                 reload_manager: Optional[ReloadManager] = None,
                 drain_timeout_s: float = 30.0,
                 tenant_header: str = "x-tenant",
                 max_body_bytes: int = _MAX_BODY_BYTES,
                 model_name: str = "bbit-hashed-linear",
                 on_started=None):
        self.engine = engine
        self.host = host
        self.port = port               # 0 → ephemeral; real port after start
        self.admission = admission or AdmissionController.for_engine(engine)
        self.reloader = reload_manager or ReloadManager(engine)
        self.drain_timeout_s = drain_timeout_s
        self.tenant_header = tenant_header.lower()
        self.max_body_bytes = max_body_bytes
        self.model_name = model_name
        self.on_started = on_started
        self.http_requests = 0
        self._t0 = time.time()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._writers: set = set()
        self._started = threading.Event()
        self._finished = threading.Event()
        self.drained_clean: Optional[bool] = None

    # ------------------------------------------------------- lifecycle ----
    def run(self, install_signals: bool = True) -> None:
        """Serve until SIGTERM/SIGINT/``request_drain()``, then drain
        gracefully and return.  Blocks the calling thread."""
        asyncio.run(self._amain(install_signals))

    def start_in_thread(self, timeout: float = 60.0) -> threading.Thread:
        """Run the server on a daemon thread (tests/examples); returns
        once the socket is bound and ``self.port`` is real."""
        t = threading.Thread(target=self.run, name="score-server",
                             kwargs={"install_signals": False},
                             daemon=True)
        t.start()
        if not self._started.wait(timeout):
            raise RuntimeError("server failed to start listening")
        return t

    def request_drain(self) -> None:
        """Thread-safe graceful-shutdown trigger (same path as SIGTERM)."""
        loop, stop = self._loop, self._stop_event
        if loop is not None and stop is not None:
            loop.call_soon_threadsafe(stop.set)

    def wait_finished(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    async def _amain(self, install_signals: bool) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        server = await asyncio.start_server(self._client, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._loop.add_signal_handler(sig,
                                                  self._stop_event.set)
                except (NotImplementedError, RuntimeError):
                    pass               # non-main thread / platform quirk
        self._started.set()
        if self.on_started is not None:
            self.on_started(self)
        try:
            await self._stop_event.wait()
            await self._drain()
        finally:
            server.close()
            # idle keep-alive connections close first: since Python
            # 3.12.1 wait_closed waits for every connection to end
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass
            await server.wait_closed()
            self._finished.set()

    async def _drain(self) -> None:
        """The graceful-shutdown sequence.  Ordering is the contract:
        (1) refuse new work (503), (2) wait for every admitted row to
        answer, (3) flush the batcher so even a straggling accepted
        future resolves — only then do sockets close."""
        self.admission.begin_drain()
        loop = asyncio.get_running_loop()
        idle = await loop.run_in_executor(
            None, self.admission.wait_idle, self.drain_timeout_s)
        await loop.run_in_executor(None, self.engine.close)
        self.drained_clean = bool(idle)

    # ------------------------------------------------------ HTTP layer ----
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except _HttpError as e:
                    await self._respond(writer, e.status,
                                        {"error": e.message}, keep=False)
                    break
                if req is None:
                    break
                if not await self._handle(req, writer):
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                BrokenPipeError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader) -> Optional[Dict]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError(400, "malformed request line")
        method, target, _version = parts
        headers: Dict[str, str] = {}
        total = len(line)
        while True:
            h = await reader.readline()
            total += len(h)
            if total > _MAX_HEADER_BYTES:
                raise _HttpError(431, "headers too large")
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, val = h.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        try:
            n = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise _HttpError(400, "bad Content-Length")
        if n > self.max_body_bytes:
            raise _HttpError(413,
                             f"body {n} bytes > {self.max_body_bytes}")
        body = await reader.readexactly(n) if n else b""
        return {"method": method, "path": target.split("?", 1)[0],
                "headers": headers, "body": body}

    async def _respond(self, writer, status: int, obj,
                       headers: Optional[Dict[str, str]] = None,
                       keep: bool = True) -> None:
        body = obj if isinstance(obj, bytes) else _json_bytes(obj)
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep else 'close'}"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _handle(self, req: Dict, writer) -> bool:
        """Route one request; returns keep-alive."""
        self.http_requests += 1
        method, path = req["method"], req["path"]
        keep = req["headers"].get("connection", "").lower() != "close"
        try:
            if path == "/score" and method == "POST":
                return await self._score(req, writer, keep)
            if path == "/score_ndjson" and method == "POST":
                return await self._score_ndjson(req, writer, keep)
            if path == "/status" and method == "GET":
                await self._respond(writer, 200, self.status(), keep=keep)
                return keep
            if path == "/healthz" and method == "GET":
                st = self.status()
                ok = st["health"] == "ok"
                await self._respond(writer, 200 if ok else 503,
                                    {"health": st["health"]}, keep=keep)
                return keep
            if path == "/reload" and method == "POST":
                return await self._reload(req, writer, keep)
            if path in ("/score", "/score_ndjson", "/reload", "/status",
                        "/healthz"):
                raise _HttpError(405, f"{method} not allowed on {path}")
            raise _HttpError(404, f"no route {method} {path}")
        except Overloaded as e:
            await self._respond(
                writer, 429,
                {"error": "overloaded",
                 "retry_after_s": e.retry_after_s, "detail": str(e)},
                headers={"Retry-After": f"{e.retry_after_s:.3f}"},
                keep=keep)
            return keep
        except Draining:
            await self._respond(writer, 503,
                                {"error": "draining",
                                 "detail": "server is shutting down"},
                                keep=False)
            return False
        except _HttpError as e:
            await self._respond(writer, e.status, {"error": e.message},
                                keep=keep)
            return keep
        except Exception as e:  # noqa: BLE001 — never kill the connection loop silently
            await self._respond(writer, 500,
                                {"error": f"{type(e).__name__}: {e}"},
                                keep=keep)
            return keep

    # ------------------------------------------------------- endpoints ----
    def _parse_docs(self, body: bytes) -> List[np.ndarray]:
        try:
            obj = json.loads(body or b"null")
        except json.JSONDecodeError:
            raise _HttpError(400, "body is not valid JSON")
        docs = obj.get("docs") if isinstance(obj, dict) else obj
        if not isinstance(docs, list) or not docs \
                or not all(isinstance(d, list) for d in docs):
            raise _HttpError(
                400, 'expected {"docs": [[id, ...], ...]} with at '
                     'least one doc')
        out = []
        for i, d in enumerate(docs):
            try:
                out.append(np.asarray(d, dtype=np.int64))
            except (TypeError, ValueError, OverflowError):
                raise _HttpError(400,
                                 f"doc {i} is not an integer id list")
        return out

    def _submit_all(self, docs: List[np.ndarray],
                    tenant: Optional[str]) -> List:
        try:
            # batch submit: with the dedup cache on, the whole request
            # keys in one vectorized host-encode pass; duck-typed so
            # an engine exposing only ``submit`` still serves
            submit_many = getattr(self.engine, "submit_many", None)
            if submit_many is not None:
                return submit_many(docs, tenant=tenant)
            return [self.engine.submit(d, tenant=tenant) for d in docs]
        except (TypeError, ValueError) as e:   # engine-side validation
            raise _HttpError(400, str(e))

    async def _score(self, req: Dict, writer, keep: bool) -> bool:
        docs = self._parse_docs(req["body"])
        tenant = req["headers"].get(self.tenant_header)
        self.admission.acquire(len(docs))
        try:
            scores, version = await self._score_single_version(docs,
                                                               tenant)
        finally:
            self.admission.release(len(docs))
        await self._respond(writer, 200,
                            {"scores": scores, "version": version,
                             "model": self.model_name}, keep=keep)
        return keep

    async def _score_single_version(self, docs, tenant
                                    ) -> Tuple[list, str]:
        loop = asyncio.get_running_loop()
        futs = self._submit_all(docs, tenant)
        results = await asyncio.gather(
            *[asyncio.wrap_future(f, loop=loop) for f in futs])
        versions = {getattr(r, "version", None) for r in results}
        if len(versions) == 1:
            ver = versions.pop() or self.engine.version
            return [_jsonable(r) for r in results], ver
        # a hot-reload landed between this request's micro-batches:
        # re-score the WHOLE batch pinned to one WeightSet so the
        # response is version-exact (rare — only the swap instant)
        w = self.engine.current_weights()
        pinned = await loop.run_in_executor(
            None, lambda: self.engine.score_docs(docs, weights=w))
        return [_jsonable(x) for x in pinned], w.version

    async def _score_ndjson(self, req: Dict, writer,
                            keep: bool) -> bool:
        lines = [ln for ln in req["body"].splitlines() if ln.strip()]
        if not lines:
            raise _HttpError(400, "empty NDJSON body")
        docs = []
        for i, ln in enumerate(lines):
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                raise _HttpError(400, f"line {i} is not valid JSON")
            if isinstance(obj, dict):
                obj = obj.get("doc")
            if not isinstance(obj, list):
                raise _HttpError(
                    400, f"line {i}: expected [id, ...] or "
                         '{"doc": [id, ...]}')
            try:
                docs.append(np.asarray(obj, dtype=np.int64))
            except (TypeError, ValueError, OverflowError):
                raise _HttpError(400,
                                 f"line {i} is not an integer id list")
        tenant = req["headers"].get(self.tenant_header)
        self.admission.acquire(len(docs))
        try:
            loop = asyncio.get_running_loop()
            futs = self._submit_all(docs, tenant)
            # headers first, then one chunk per resolved score — the
            # client sees early scores while later docs still queue
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/x-ndjson\r\n"
                b"Transfer-Encoding: chunked\r\n"
                b"Connection: " +
                (b"keep-alive" if keep else b"close") + b"\r\n\r\n")
            try:
                for i, f in enumerate(futs):
                    r = await asyncio.wrap_future(f, loop=loop)
                    payload = _json_bytes(
                        {"i": i, "score": _jsonable(r),
                         "version": getattr(r, "version",
                                            self.engine.version)}
                    ) + b"\n"
                    writer.write(b"%x\r\n%s\r\n" % (len(payload),
                                                    payload))
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            except Exception as e:  # noqa: BLE001 — headers already sent
                payload = _json_bytes(
                    {"error": f"{type(e).__name__}: {e}"}) + b"\n"
                writer.write(b"%x\r\n%s\r\n0\r\n\r\n"
                             % (len(payload), payload))
                await writer.drain()
                return False
        finally:
            self.admission.release(len(docs))
        return keep

    async def _reload(self, req: Dict, writer, keep: bool) -> bool:
        try:
            obj = json.loads(req["body"] or b"null")
        except json.JSONDecodeError:
            raise _HttpError(400, "body is not valid JSON")
        if not isinstance(obj, dict) or not obj.get("ckpt_dir"):
            raise _HttpError(400, 'expected {"ckpt_dir": ..., '
                                  '"step"?: int, "version"?: str}')
        loop = asyncio.get_running_loop()
        try:
            info = await loop.run_in_executor(
                None, lambda: self.reloader.reload_from_checkpoint(
                    obj["ckpt_dir"], step=obj.get("step"),
                    version=obj.get("version")))
        except FileNotFoundError as e:
            await self._respond(writer, 404, {"error": str(e)},
                                keep=keep)
            return keep
        except ValueError as e:
            await self._respond(writer, 409, {"error": str(e)},
                                keep=keep)
            return keep
        await self._respond(writer, 200, info, keep=keep)
        return keep

    def status(self) -> Dict:
        """Full engine ``stats()`` merged at the top level (keys are a
        superset of the engine's, so new engine sections — ``dedup``,
        ``kernels`` — surface here without server changes), with the
        server's own scalars layered on top: ``health`` flattens to the
        drain-aware string, ``uptime_s``/``version`` are the server's
        view, and the verbatim engine snapshot stays nested under
        ``engine`` for existing consumers."""
        eng = self.engine.stats()
        adm = self.admission.snapshot()
        health = ("draining" if adm["draining"]
                  else eng["health"]["state"])
        out = dict(eng)
        out.update({"health": health, "version": eng["version"],
                    "model": self.model_name,
                    "uptime_s": time.time() - self._t0,
                    "http_requests": self.http_requests,
                    "engine": eng, "admission": adm})
        return out


class HTTPStatusError(RuntimeError):
    """Non-2xx from the server; carries status + parsed payload."""

    def __init__(self, status: int, payload, retry_after_s=None):
        super().__init__(f"HTTP {status}: {payload}")
        self.status = status
        self.payload = payload
        self.retry_after_s = retry_after_s


class ScoreClient:
    """Minimal blocking keep-alive client for examples/benches/tests
    (stdlib ``http.client``; one instance per thread).

    ``retries > 0`` opts JSON calls into bounded retry on 429
    (admission Overloaded) and 503 (Draining): each rejected attempt
    waits out max(the server's ``Retry-After`` hint, the capped
    exponential backoff with deterministic jitter from
    ``repro_torch.ft.retry.BackoffPolicy(seed=retry_seed)``), then
    reissues the request.  Other statuses (and exhausted retries) raise
    ``HTTPStatusError`` exactly as with ``retries=0`` (the default —
    no behavior change for existing callers).
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0,
                 *, retries: int = 0,
                 backoff: Optional["BackoffPolicy"] = None,
                 retry_seed: int = 0):
        self.host, self.port, self.timeout = host, port, timeout
        self.retries = int(retries)
        self.backoff = (BackoffPolicy(base_s=0.02, factor=2.0,
                                      cap_s=1.0, jitter_frac=0.1,
                                      seed=retry_seed)
                        if backoff is None else backoff)
        self._conn: Optional[http.client.HTTPConnection] = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def request(self, method: str, path: str, body=None,
                headers: Optional[Dict[str, str]] = None):
        """→ (status, headers dict, parsed-JSON body or raw response
        object for streams).  Retries once on a dropped keep-alive."""
        payload = _json_bytes(body) if isinstance(body, (dict, list)) \
            else body
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=payload, headers=hdrs)
                resp = conn.getresponse()
                break
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError):
                self.close()
                if attempt:
                    raise
        return resp

    def _json_call(self, method, path, body=None, headers=None):
        for attempt in range(self.retries + 1):
            resp = self.request(method, path, body, headers)
            data = resp.read()
            try:
                obj = json.loads(data) if data else None
            except json.JSONDecodeError:
                obj = data.decode("latin-1", "replace")
            if resp.status < 300:
                return obj
            ra = resp.getheader("Retry-After")
            err = HTTPStatusError(resp.status, obj,
                                  retry_after_s=float(ra) if ra else None)
            if resp.status not in (429, 503) or attempt >= self.retries:
                raise err
            # back-pressure statuses: honor the server's Retry-After
            # hint, floored by our own deterministic backoff curve
            time.sleep(max(err.retry_after_s or 0.0,
                           self.backoff.delay_s(attempt)))

    def score(self, docs: Sequence[Sequence[int]],
              tenant: Optional[str] = None) -> Dict:
        docs = [np.asarray(d).tolist() for d in docs]
        hdrs = {"X-Tenant": tenant} if tenant else None
        return self._json_call("POST", "/score", {"docs": docs}, hdrs)

    def score_ndjson(self, docs: Sequence[Sequence[int]],
                     tenant: Optional[str] = None) -> List[Dict]:
        body = b"".join(_json_bytes(np.asarray(d).tolist()) + b"\n"
                        for d in docs)
        hdrs = {"Content-Type": "application/x-ndjson"}
        if tenant:
            hdrs["X-Tenant"] = tenant
        resp = self.request("POST", "/score_ndjson", body, hdrs)
        if resp.status >= 300:
            raise HTTPStatusError(resp.status,
                                  json.loads(resp.read() or b"null"))
        out = []
        for line in resp.read().splitlines():   # http.client de-chunks
            if line.strip():
                out.append(json.loads(line))
        for entry in out:
            if "error" in entry:
                raise HTTPStatusError(500, entry)
        return out

    def status(self) -> Dict:
        return self._json_call("GET", "/status")

    def healthz(self) -> Dict:
        return self._json_call("GET", "/healthz")

    def reload(self, ckpt_dir: str, step: Optional[int] = None,
               version: Optional[str] = None) -> Dict:
        body = {"ckpt_dir": ckpt_dir}
        if step is not None:
            body["step"] = step
        if version is not None:
            body["version"] = version
        return self._json_call("POST", "/reload", body)
