"""JSON-RPC 2.0 server over HTTP and WebSocket subscriptions (counterpart
of ``cometbft_tpu/rpc/server.py``; reference: ``rpc/jsonrpc/server/
{http_json_handler,http_uri_handler,ws_handler}.go``, ``WebsocketManager``
at ``ws_handler.go:32``).

Three access styles, as in the reference:

- POST ``/`` with a JSON-RPC body ``{"jsonrpc":"2.0","id":..,"method":..,
  "params":{..}}``, or a JSON array of such bodies (a batch);
- GET ``/<method>?param=value`` (URI style; ints, ``0x..`` hex and quoted
  strings are coerced);
- GET ``/websocket`` upgraded to a WebSocket carrying JSON-RPC frames,
  where ``subscribe``/``unsubscribe`` manage event-bus subscriptions in
  the query language of ``libs/query`` (``tm.event='NewBlock' AND
  tx.hash='..'``) and matching events are pushed as notifications.

Besides: ``GET /metrics`` (Prometheus text), ``GET /openapi`` (the route
table as OpenAPI 3.0), CORS from ``rpc.cors_*``, TLS when both
``rpc.tls_cert_file`` and ``rpc.tls_key_file`` are set, and an admission
gate that sheds with HTTP 503 and Retry-After past
``rpc.max_concurrent_requests`` running and ``rpc.max_queued_requests``
waiting handlers (diagnostic routes bypass it).  HTTP/1.1 and RFC 6455
text frames are hand-rolled on asyncio streams."""

from __future__ import annotations

import asyncio
import base64
import functools
import hashlib
import inspect
import json
import math
import os
import ssl
import struct
from urllib.parse import parse_qsl, unquote, urlsplit

from ..config import RPCConfig
from ..libs import metrics as _metrics
from ..libs.query import Query, QuerySyntaxError
from .core import ROUTES, UNSAFE_ROUTES, Environment, RPCError
from .json import jsonable

__all__ = ["RPCServer", "compile_query", "parse_query", "UNGATED_METHODS"]

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
# A WebSocket frame past this drops the connection, and so does a request
# body past it unless LARGE_BODY_BUDGET has room for it.
MAX_BODY = 10 << 20
# Request bodies past MAX_BODY share this many bytes, server-wide, from
# the moment their length is read until their response is written; a
# body that does not fit drops its connection.  The light routes' own
# bounds need it: ``lightserve.max_batch`` (128) anchors at 1,000
# validators are about 31 MB of commit JSON, past MAX_BODY from 42
# anchors on.  So the bytes that clients can pin before the admission
# gate stay MAX_BODY a connection (``rpc.max_open_connections`` of them)
# plus this.  Bodies over 4 KB are parsed in a worker thread, off the
# event loop.
LARGE_BODY_BUDGET = 64 << 20

# Routes that bypass the overload-shedding admission gate: the node's
# own diagnostics must answer while the node sheds a request flood (an
# operator debugging the flood needs /status and /net_info most then).
# All are cheap in-memory reads.
UNGATED_METHODS = frozenset(
    {"health", "status", "net_info", "dump_trace"})
# POST bodies up to this size are parsed BEFORE the gate to check the
# exemption; anything larger is gated unconditionally so a flood of fat
# bodies can't buy a 10MB json.loads per shed request
_GATE_PROBE_MAX_BODY = 4096
# responses that can run megabytes: serialize in a worker thread (the
# light-serve routes ship whole proof sets / light-block batches, and
# even a single light_block embeds the full valset JSON — ~1 MB at 10k
# validators on the provider's preferred single-round-trip path)
_THREAD_ENCODE_METHODS = frozenset(
    {"dump_trace",
     "light_block", "light_blocks", "light_proofs", "light_verify",
     # block- and set-scaled payloads (a 10,000-validator commit alone
     # is megabytes of JSON): inline, their encode stalls every other
     # connection
     "block", "block_by_hash", "block_results", "blockchain", "commit",
     "validators", "genesis", "genesis_chunked", "tx_search",
     "block_search", "unconfirmed_txs", "dump_consensus_state"})


@functools.cache
def _gate_metrics():
    return _metrics.counter(
        "rpc_requests_shed_total",
        "HTTP requests rejected with 503 by the RPC admission gate "
        "(concurrency limit hit AND the wait queue full)")


def compile_query(q: str) -> Query:
    """Compile a query string with the full grammar of ``libs/query``
    (reference ``libs/pubsub/query``), mapping syntax errors to JSON-RPC
    invalid-params."""
    try:
        return Query.parse(q)
    except QuerySyntaxError as e:
        raise RPCError(-32602, f"bad query: {e}") from e


def parse_query(q: str) -> dict[str, str]:
    """``tm.event='NewBlock' AND tx.hash='AB12'`` -> equality dict.  Kept
    for callers that only need the posting-index subset: a query with any
    non-equality condition is REJECTED here (use ``compile_query`` for
    the full grammar) so an empty/partial dict can never silently match
    everything.  Bare ``=`` clauses without quotes are tolerated for CLI
    ergonomics."""
    try:
        compiled = compile_query(q)
    except RPCError:
        out = {}
        for clause in q.split(" AND "):
            clause = clause.strip()
            if not clause:
                continue
            if "=" not in clause:
                raise RPCError(-32602, f"bad query clause {clause!r}")
            k, v = clause.split("=", 1)
            out[k.strip()] = v.strip().strip("'\"")
        return out
    eq = compiled.equality_clauses()
    if len(eq) != len(compiled.conditions):
        raise RPCError(-32602,
                       "query has non-equality conditions; this endpoint "
                       "supports the equality subset only")
    return eq


def _coerce(v: str):
    v = unquote(v)
    if v.startswith('"') and v.endswith('"'):
        return v[1:-1]
    if v.startswith("0x"):
        return bytes.fromhex(v[2:])
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        return v


class RPCServer:
    def __init__(self, node, routes: dict | None = None):
        """``routes`` overrides the default route table (the light proxy
        serves verified routes against a light client instead)."""
        self.env = Environment(node)
        cfg = getattr(node, "config", None)
        if routes is not None:
            self.routes = routes
        else:
            self.routes = dict(ROUTES)
            if cfg is not None and getattr(cfg.rpc, "unsafe", False):
                self.routes.update(UNSAFE_ROUTES)
        self._server: asyncio.Server | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._large_free = LARGE_BODY_BUDGET
        self._ws_counter = 0
        # CORS + TLS from config (config/config.go:353-364,428-442); a
        # config-less node (light proxy shim) gets RPCConfig's defaults —
        # ONE source of truth, and an explicitly configured empty list
        # stays empty
        rpc_cfg = getattr(cfg, "rpc", None)
        if rpc_cfg is None:
            rpc_cfg = RPCConfig()
        self._cors_origins = list(rpc_cfg.cors_allowed_origins)
        self._cors_methods = list(rpc_cfg.cors_allowed_methods)
        self._cors_headers = list(rpc_cfg.cors_allowed_headers)
        self._ssl_ctx = self._build_ssl(rpc_cfg, getattr(node, "home", None))
        # connections past this are closed on accept (0: no limit)
        self._max_conns = max(0, int(getattr(
            rpc_cfg, "max_open_connections", 0)))
        self._openapi_raw: bytes | None = None
        # ---- overload-shedding admission gate -------------------------
        # at most max_concurrent_requests handlers run at once; up to
        # max_queued_requests more wait on the semaphore; past that the
        # request is shed with 503 + Retry-After.  Diagnostic routes
        # (UNGATED_METHODS) bypass the gate entirely.
        self._gate_max = max(1, int(getattr(
            rpc_cfg, "max_concurrent_requests", 64)))
        self._gate_max_queued = max(0, int(getattr(
            rpc_cfg, "max_queued_requests", 256)))
        self._gate_retry_after = max(1, math.ceil(float(getattr(
            rpc_cfg, "shed_retry_after_s", 1.0)) or 1))
        self._gate_sem = asyncio.Semaphore(self._gate_max)
        self._gate_active = 0
        self._gate_queued = 0
        self._m_shed = _gate_metrics()

    @staticmethod
    def _build_ssl(rpc_cfg, home):
        """ssl.SSLContext when BOTH tls_cert_file and tls_key_file are
        configured (else plain HTTP), resolving relative paths against
        the home's config dir like the reference (config.go CertFile())."""
        cert = rpc_cfg.tls_cert_file or ""
        key = rpc_cfg.tls_key_file or ""
        if not cert or not key:
            return None
        conf_dir = os.path.join(home or ".", "config")
        if not os.path.isabs(cert):
            cert = os.path.join(conf_dir, cert)
        if not os.path.isabs(key):
            key = os.path.join(conf_dir, key)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        return ctx

    def _origin_allowed(self, origin: str) -> str | None:
        """The Access-Control-Allow-Origin value for ``origin``, or None
        when CORS is off / the origin isn't allowed.  Each allowed origin
        may carry ONE ``*`` wildcard (rs/cors semantics the reference
        wires in rpc/jsonrpc/server)."""
        if not origin or not self._cors_origins:
            return None
        # the matched origin is echoed into a response header: control
        # characters (a smuggled bare CR especially) must never pass a
        # wildcard match into the response (header-injection vector)
        if any(ord(ch) < 0x20 or ord(ch) == 0x7F for ch in origin):
            return None
        for allowed in self._cors_origins:
            if allowed == "*":
                return "*"
            if "*" in allowed:
                head, _, tail = allowed.partition("*")
                if origin.startswith(head) and origin.endswith(tail) and \
                        len(origin) >= len(head) + len(tail):
                    return origin
            elif allowed == origin:
                return origin
        return None

    def _cors_response_headers(self, headers: dict) -> bytes:
        if not self._cors_origins:
            return b""
        allow = self._origin_allowed(headers.get("origin", ""))
        # Vary: Origin goes on EVERY response once CORS is on (match or
        # not) — a shared cache must never serve an Origin-less cached
        # response to a browser on an allowed origin (rs/cors behavior)
        out = "Vary: Origin\r\n"
        if allow is not None:
            out += f"Access-Control-Allow-Origin: {allow}\r\n"
        return out.encode()

    async def listen(self, host: str = "127.0.0.1",
                     port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._serve, host, port,
                                                  ssl=self._ssl_ctx)
        addr = self._server.sockets[0].getsockname()
        return addr[0], addr[1]

    async def close(self) -> None:
        # cancel every live connection handler: Server.wait_closed() on
        # 3.12+ waits for them all, and an idle keep-alive client would
        # otherwise block shutdown forever
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def openapi_spec(self) -> dict:
        """OpenAPI 3.0 document derived from the LIVE route table by
        introspection (handler signatures + docstrings), the role of the
        reference's hand-written ``rpc/openapi/openapi.yaml``."""
        paths = {}
        for name in sorted(self.routes):
            fn = self.routes[name]
            params = []
            try:
                sig = inspect.signature(fn)
            except (TypeError, ValueError):
                sig = None
            if sig is not None:
                for pname, p in sig.parameters.items():
                    if pname == "env" or p.kind in (
                            p.VAR_POSITIONAL, p.VAR_KEYWORD):
                        continue
                    params.append({
                        "name": pname,
                        "in": "query",
                        "required": p.default is inspect.Parameter.empty,
                        "schema": {"type": "string"},
                    })
            doc = inspect.getdoc(fn) or ""
            paths[f"/{name}"] = {"get": {
                "operationId": name,
                "summary": doc.splitlines()[0] if doc else name,
                "description": doc,
                "parameters": params,
                "responses": {"200": {
                    "description": "JSON-RPC 2.0 envelope",
                    "content": {"application/json": {"schema": {
                        "type": "object"}}},
                }},
            }}
        return {
            "openapi": "3.0.0",
            "info": {
                "title": "cometbft-tpu RPC",
                "version": "1.0",
                "description": (
                    "JSON-RPC 2.0 over HTTP: every path also accepts "
                    "POST / with {jsonrpc, id, method, params}, and "
                    "/websocket carries the same methods plus "
                    "subscribe/unsubscribe."),
            },
            "paths": paths,
        }

    # ------------------------------------------------------- admission gate

    async def _gate_admit(self) -> bool:
        """Enter the concurrency gate: returns False (shed) when the
        run slots are full AND the wait queue is at capacity."""
        if self._gate_active >= self._gate_max and \
                self._gate_queued >= self._gate_max_queued:
            self._m_shed.inc()
            return False
        self._gate_queued += 1
        try:
            await self._gate_sem.acquire()
        finally:
            self._gate_queued -= 1
        self._gate_active += 1
        return True

    def _gate_done(self) -> None:
        self._gate_active -= 1
        self._gate_sem.release()

    def _write_503(self, writer: asyncio.StreamWriter, cors: bytes) -> None:
        body = json.dumps({
            "jsonrpc": "2.0", "id": None,
            "error": {"code": -32000,
                      "message": "server overloaded; retry later",
                      "data": ""}}).encode()
        writer.write(
            b"HTTP/1.1 503 Service Unavailable\r\n"
            b"Content-Type: application/json\r\n" + cors +
            b"Retry-After: " + str(self._gate_retry_after).encode() +
            b"\r\nContent-Length: " + str(len(body)).encode() +
            b"\r\nConnection: keep-alive\r\n\r\n" + body)

    # ------------------------------------------------------------- http

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if self._max_conns and len(self._conn_tasks) >= self._max_conns:
            writer.close()
            return
        self._conn_tasks.add(task)
        held = 0            # bytes of LARGE_BODY_BUDGET this request holds
        try:
            while True:
                self._large_free += held
                held = 0
                req_line = await reader.readline()
                if not req_line:
                    return
                try:
                    method, target, _version = \
                        req_line.decode().strip().split(" ", 2)
                except ValueError:
                    return
                headers = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()

                if headers.get("upgrade", "").lower() == "websocket":
                    await self._websocket(reader, writer, headers)
                    return

                body = b""
                try:
                    ln = int(headers.get("content-length", 0))
                except ValueError:
                    return          # unparseable framing: drop connection
                if ln < 0:
                    return
                if ln:
                    if ln > MAX_BODY:
                        if ln > self._large_free:
                            return
                        self._large_free -= ln
                        held = ln
                    body = await reader.readexactly(ln)

                cors = self._cors_response_headers(headers)
                if method == "OPTIONS":
                    # CORS preflight: 204 with the allow-* set when the
                    # origin matches; bare 204 otherwise (rs/cors shape)
                    pre = b""
                    if cors:
                        pre = cors + (
                            "Access-Control-Allow-Methods: "
                            f"{', '.join(self._cors_methods)}\r\n"
                            "Access-Control-Allow-Headers: "
                            f"{', '.join(self._cors_headers)}\r\n"
                            "Access-Control-Max-Age: 600\r\n").encode()
                    writer.write(
                        b"HTTP/1.1 204 No Content\r\n" + pre +
                        b"Content-Length: 0\r\n"
                        b"Connection: keep-alive\r\n\r\n")
                    await writer.drain()
                    if headers.get("connection", "").lower() == "close":
                        return
                    continue
                path = urlsplit(target).path
                if method in ("GET", "HEAD") and path == "/metrics":
                    # Prometheus text exposition (the reference serves this
                    # on the instrumentation port; here it rides the RPC
                    # listener).  HEAD gets GET's headers, no body
                    # (RFC 9110 9.3.2).
                    text = _metrics.DEFAULT.collect().encode()
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4\r\n"
                        + cors +
                        b"Content-Length: " + str(len(text)).encode() +
                        b"\r\nConnection: keep-alive\r\n\r\n" +
                        (b"" if method == "HEAD" else text))
                    await writer.drain()
                    if headers.get("connection", "").lower() == "close":
                        return
                    continue
                if method in ("GET", "HEAD") and path == "/openapi":
                    # machine-readable route table (the reference ships
                    # rpc/openapi/openapi.yaml; here the spec is derived
                    # from the live table so it can never go stale);
                    # routes are fixed after __init__ so the serialized
                    # document is computed once
                    if self._openapi_raw is None:
                        self._openapi_raw = json.dumps(
                            self.openapi_spec()).encode()
                    text = self._openapi_raw
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: application/json\r\n" + cors +
                        b"Content-Length: " + str(len(text)).encode() +
                        b"\r\nConnection: keep-alive\r\n\r\n" +
                        (b"" if method == "HEAD" else text))
                    await writer.drain()
                    if headers.get("connection", "").lower() == "close":
                        return
                    continue
                # overload shedding: every non-diagnostic request enters
                # the admission gate; at capacity it gets 503+Retry-After
                # while /status and friends keep answering.  The shed
                # decision must stay cheap: only SMALL POST bodies are
                # parsed pre-gate to check the exemption (a diagnostic
                # call is never megabytes) — large bodies are gated
                # unconditionally and parsed only once admitted.
                req = parse_err = None
                parsed = False
                rpc_method = None
                if method == "POST":
                    if len(body) <= _GATE_PROBE_MAX_BODY:
                        req, parse_err = self._parse_jsonrpc(body)
                        parsed = True
                        rpc_method = req.get("method") \
                            if isinstance(req, dict) else None
                        gated = parse_err is None and \
                            rpc_method not in UNGATED_METHODS
                    else:
                        gated = True
                elif method in ("GET", "HEAD"):
                    rpc_method = path.strip("/")
                    gated = rpc_method not in UNGATED_METHODS
                else:
                    gated = False        # error response, no handler runs
                if gated and not await self._gate_admit():
                    self._write_503(writer, cors)
                    await writer.drain()
                    if headers.get("connection", "").lower() == "close":
                        return
                    continue
                try:
                    if method == "POST":
                        if not parsed:
                            # only >probe-size bodies reach here
                            # unparsed — decode those off the loop
                            req, parse_err = await asyncio.to_thread(
                                self._parse_jsonrpc, body)
                            if isinstance(req, dict):
                                rpc_method = req.get("method")
                        resp = parse_err if parse_err is not None else \
                            await self._handle_jsonrpc_obj(req)
                    elif method in ("GET", "HEAD"):
                        resp = await self._handle_uri(target)
                    else:
                        resp = _rpc_error(None, -32600,
                                          f"unsupported method {method}")
                finally:
                    if gated:
                        self._gate_done()
                if rpc_method in _THREAD_ENCODE_METHODS or \
                        isinstance(req, list):
                    # megabyte payloads (blocks, sets, light batches,
                    # trace dumps) serialize off the event loop; a batch
                    # has no single method and can stack heavy calls, so
                    # it always thread-encodes
                    raw = await asyncio.to_thread(json.dumps, resp)
                    raw = raw.encode()
                else:
                    raw = json.dumps(resp).encode()
                writer.write(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/json\r\n" + cors +
                    b"Content-Length: " + str(len(raw)).encode() +
                    b"\r\nConnection: keep-alive\r\n\r\n" +
                    (b"" if method == "HEAD" else raw))
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    return
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            self._large_free += held
            self._conn_tasks.discard(task)
            writer.close()

    @staticmethod
    def _parse_jsonrpc(body: bytes):
        """(parsed request, None) or (None, error response)."""
        try:
            return json.loads(body), None
        except json.JSONDecodeError as e:
            return None, _rpc_error(None, -32700, f"parse error: {e}")

    async def _handle_jsonrpc_obj(self, req):
        if isinstance(req, list):
            # JSON-RPC batch (rpc/jsonrpc/server/http_json_handler.go:46);
            # notifications (no id) get no response entry
            out = []
            for r in req:
                if not isinstance(r, dict) or r.get("id") is None:
                    continue
                out.append(await self._dispatch(
                    r.get("id"), r.get("method", ""),
                    r.get("params") or {}))
            return out
        if not isinstance(req, dict):
            return _rpc_error(None, -32600,
                              f"invalid request: {type(req).__name__}")
        return await self._dispatch(req.get("id"), req.get("method", ""),
                                    req.get("params") or {})

    async def _handle_uri(self, target: str) -> dict:
        parts = urlsplit(target)
        method = parts.path.strip("/")
        if not method:
            return {"jsonrpc": "2.0", "id": -1,
                    "result": {"routes": sorted(self.routes)}}
        try:
            params = {k: _coerce(v) for k, v in parse_qsl(parts.query)}
        except ValueError as e:       # e.g. odd-length 0x hex
            return _rpc_error(-1, -32602, f"bad parameter: {e}")
        return await self._dispatch(-1, method, params)

    async def _dispatch(self, rid, method: str, params: dict) -> dict:
        handler = self.routes.get(method)
        if handler is None:
            return _rpc_error(rid, -32601, f"method {method!r} not found")
        try:
            result = await handler(self.env, **params)
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except RPCError as e:
            return _rpc_error(rid, e.code, e.message, e.data)
        except TypeError as e:
            return _rpc_error(rid, -32602, f"invalid params: {e}")
        except Exception as e:       # noqa: BLE001 — route bugs become errors
            return _rpc_error(rid, -32603, f"{type(e).__name__}: {e}")

    # -------------------------------------------------------- websocket

    async def _websocket(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key", "")
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
        writer.write((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        await writer.drain()
        session = _WsSession(self, reader, writer)
        try:
            await session.run()
        finally:
            session.cleanup()


class _WsSession:
    """One WebSocket connection: JSON-RPC requests in, responses and
    subscription notifications out (ws_handler.go wsConnection)."""

    def __init__(self, server: RPCServer, reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        server._ws_counter += 1
        self.sid = f"ws-{server._ws_counter}"
        self.subs: dict[str, asyncio.Task] = {}   # query -> pump task

    def cleanup(self) -> None:
        if not self.subs:
            return              # never touch the bus if nothing subscribed
        bus = self.server.env.node.event_bus
        for query, task in self.subs.items():
            task.cancel()
            bus.unsubscribe(f"{self.sid}:{query}")
        self.subs.clear()

    async def run(self) -> None:
        try:
            while True:
                op, payload = await self._read_frame()
                if op == 8:                       # close
                    return
                if op == 9:                       # ping -> pong
                    await self._send_frame(10, payload)
                    continue
                if op not in (1, 2):
                    continue
                try:
                    if len(payload) > _GATE_PROBE_MAX_BODY:
                        # fat frames (tx broadcasts can ride ws) parse
                        # off the loop, like >4KB HTTP bodies
                        req = await asyncio.to_thread(json.loads, payload)
                    else:
                        req = json.loads(payload)
                except json.JSONDecodeError:
                    await self._send_json(_rpc_error(None, -32700,
                                                     "parse error"))
                    continue
                if not isinstance(req, dict):
                    # subscribe/unsubscribe semantics don't compose with
                    # JSON-RPC batches; the HTTP path serves those
                    await self._send_json(_rpc_error(
                        None, -32600,
                        "websocket frames must carry a single "
                        "JSON-RPC object (use HTTP POST for batches)"))
                    continue
                await self._handle(req)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.writer.close()

    async def _handle(self, req: dict) -> None:
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params") or {}
        if method == "subscribe":
            await self._subscribe(rid, params.get("query", ""))
        elif method == "unsubscribe":
            self._unsubscribe(params.get("query", ""))
            await self._send_json({"jsonrpc": "2.0", "id": rid,
                                   "result": {}})
        elif method == "unsubscribe_all":
            for q in list(self.subs):
                self._unsubscribe(q)
            await self._send_json({"jsonrpc": "2.0", "id": rid,
                                   "result": {}})
        elif method in UNGATED_METHODS:
            resp = await self.server._dispatch(rid, method, params)
            if method in _THREAD_ENCODE_METHODS:
                # multi-MB diagnostic payloads encode off the loop on
                # the ws path too
                raw = await asyncio.to_thread(json.dumps, resp)
                await self._send_frame(1, raw.encode())
            else:
                await self._send_json(resp)
        else:
            # the admission gate bounds handler concurrency NODE-WIDE:
            # a flood over websockets must shed like one over HTTP
            # (here as a JSON-RPC error — there is no 503 frame)
            if not await self.server._gate_admit():
                await self._send_json(_rpc_error(
                    rid, -32000, "server overloaded; retry later"))
                return
            try:
                resp = await self.server._dispatch(rid, method, params)
            finally:
                self.server._gate_done()
            if method in _THREAD_ENCODE_METHODS:
                # block-/valset-scaled payloads encode off the loop on
                # the gated ws path too
                raw = await asyncio.to_thread(json.dumps, resp)
                await self._send_frame(1, raw.encode())
            else:
                await self._send_json(resp)

    async def _subscribe(self, rid, query: str) -> None:
        try:
            compiled = compile_query(query)
        except RPCError as e:
            await self._send_json(_rpc_error(rid, e.code, e.message))
            return
        if query in self.subs:
            await self._send_json(_rpc_error(rid, -32603,
                                             "already subscribed"))
            return
        bus = getattr(self.server.env.node, "event_bus", None)
        if bus is None:
            await self._send_json(_rpc_error(
                rid, -32601, "subscriptions not supported on this server"))
            return
        sub = bus.subscribe(f"{self.sid}:{query}", compiled)
        self.subs[query] = asyncio.create_task(self._pump(query, sub))
        await self._send_json({"jsonrpc": "2.0", "id": rid, "result": {}})

    def _unsubscribe(self, query: str) -> None:
        task = self.subs.pop(query, None)
        if task is not None:
            task.cancel()
        self.server.env.node.event_bus.unsubscribe(f"{self.sid}:{query}")

    async def _pump(self, query: str, sub) -> None:
        """Push matching events as JSON-RPC notifications.  Event
        payloads carry whole blocks (NewBlock at 10,000 validators is
        megabytes of JSON), so notifications thread-encode; acks stay
        inline."""
        try:
            while True:
                msg = await sub.queue.get()

                def _encode(m=msg, q=query):
                    # the jsonable projection of a whole block costs as
                    # much as the dumps — both belong off the loop
                    return json.dumps({
                        "jsonrpc": "2.0", "id": None,
                        "result": {"query": q,
                                   "data": {"type": m.event_type,
                                            "value": _event_value(m)},
                                   "events": m.attrs}})
                raw = await asyncio.to_thread(_encode)
                await self._send_frame(1, raw.encode())
        except (asyncio.CancelledError, ConnectionError):
            pass

    @staticmethod
    def _decode_len(b: int) -> int:
        return b & 0x7F

    async def _read_frame(self) -> tuple[int, bytes]:
        hdr = await self.reader.readexactly(2)
        op = hdr[0] & 0x0F
        masked = hdr[1] & 0x80
        ln = hdr[1] & 0x7F
        if ln == 126:
            (ln,) = struct.unpack(">H", await self.reader.readexactly(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", await self.reader.readexactly(8))
        if ln > MAX_BODY:
            raise ConnectionError(f"oversized ws frame ({ln} bytes)")
        mask = await self.reader.readexactly(4) if masked else b"\x00" * 4
        data = await self.reader.readexactly(ln)
        if masked and ln:
            # bulk XOR through one big int: a per-byte loop holds the
            # event loop for about a second on a 10 MiB frame
            pad = mask * ((ln + 3) // 4)
            data = (int.from_bytes(data, "little") ^
                    int.from_bytes(pad[:ln], "little")
                    ).to_bytes(ln, "little")
        return op, bytes(data)

    async def _send_frame(self, op: int, payload: bytes) -> None:
        ln = len(payload)
        if ln < 126:
            hdr = bytes([0x80 | op, ln])
        elif ln < (1 << 16):
            hdr = bytes([0x80 | op, 126]) + struct.pack(">H", ln)
        else:
            hdr = bytes([0x80 | op, 127]) + struct.pack(">Q", ln)
        self.writer.write(hdr + payload)
        await self.writer.drain()

    async def _send_json(self, obj: dict) -> None:
        await self._send_frame(1, json.dumps(obj).encode())


def _event_value(msg):
    """Project event payloads to JSON-able form."""
    data = msg.data
    if isinstance(data, dict):
        out = {}
        for k, v in data.items():
            try:
                out[k] = jsonable(v)
            except TypeError:
                out[k] = repr(v)
        return out
    try:
        return jsonable(data)
    except TypeError:
        return repr(data)


def _rpc_error(rid, code: int, message: str, data: str = "") -> dict:
    return {"jsonrpc": "2.0", "id": rid,
            "error": {"code": code, "message": message, "data": data}}
