"""JSON-RPC clients (counterpart of ``cometbft_tpu/rpc/client.py``;
reference: ``rpc/jsonrpc/client/{http_json_client,ws_client}.go``): an
HTTP client for request/response routes and batches, and a WebSocket
client for event subscriptions.  Either talks to a port or a JAX
package server: the wire is the same."""

from __future__ import annotations

import asyncio
import base64
import json
import os
import struct

from .core import RPCError

__all__ = ["HTTPClient", "WSClient"]


def _err(err: dict) -> "RPCError":
    return RPCError(err.get("code", -1), err.get("message", ""),
                    err.get("data", ""))


class HTTPClient:
    """Keep-alive JSON-RPC client: one persistent connection per client,
    requests serialized on it (the server speaks HTTP/1.1 keep-alive).
    Concurrency comes from using one client per task."""

    def __init__(self, host: str, port: int, *, tls: bool = False,
                 tls_verify: bool = True):
        """``tls=True`` speaks HTTPS to a server configured with
        tls_cert_file/tls_key_file (the reference's client accepts
        https:// addresses); ``tls_verify=False`` accepts self-signed
        certs (operator tooling against a node's own cert)."""
        self.host = host
        self.port = port
        self._ssl = None
        if tls:
            import ssl as _ssl

            ctx = _ssl.create_default_context()
            if not tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = _ssl.CERT_NONE
            self._ssl = ctx
        self._id = 0
        self._conn = None                  # (reader, writer) when alive
        self._lock = asyncio.Lock()        # one in-flight request/conn

    def clone(self) -> "HTTPClient":
        """A fresh client for the same endpoint WITH the same TLS
        settings (per-worker fan-out must not silently drop https)."""
        c = HTTPClient(self.host, self.port)
        c._ssl = self._ssl
        return c

    async def close(self) -> None:
        if self._conn is not None:
            _, writer = self._conn
            self._conn = None
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def call(self, method: str, **params):
        self._id += 1
        rid = self._id          # NOT self._id at response time: another
        #   task sharing this client may bump the counter while we await
        resp = await self._post(
            json.dumps({"jsonrpc": "2.0", "id": rid,
                        "method": method, "params": params}).encode(),
            retry_ok=not method.startswith("broadcast_"))
        if isinstance(resp, dict) and resp.get("id") not in (None, rid):
            # a desynced keep-alive stream answered with a stale
            # response: poison the connection and fail loudly
            await self.close()
            raise RPCError(-32000,
                           f"response id {resp.get('id')} != {rid}")
        if "error" in resp:
            raise _err(resp["error"])
        return resp["result"]

    async def call_batch(self, calls: list[tuple[str, dict]]) -> list:
        """JSON-RPC batch (rpc/jsonrpc/client BatchHTTPClient): one HTTP
        round-trip for many requests.  Returns per-call results in
        request order; an errored call's slot holds the RPCError."""
        reqs = []
        for method, params in calls:
            self._id += 1
            reqs.append({"jsonrpc": "2.0", "id": self._id,
                         "method": method, "params": params})
        resps = await self._post(
            json.dumps(reqs).encode(),
            retry_ok=all(not m.startswith("broadcast_")
                         for m, _ in calls))
        if not isinstance(resps, list):
            # whole-batch failure: the server answered with a single
            # error object (e.g. parse error) instead of an array
            if isinstance(resps, dict) and "error" in resps:
                raise _err(resps["error"])
            raise RPCError(-32700, f"malformed batch response: {resps!r}")
        by_id = {r.get("id"): r for r in resps if isinstance(r, dict)}
        matched = any(req["id"] in by_id for req in reqs)
        stale_ids = [r["id"] for r in resps if isinstance(r, dict)
                     and r.get("id") is not None
                     and not any(req["id"] == r["id"] for req in reqs)]
        if resps and not matched and stale_ids:
            # responses carry ids that belong to NO request: a desynced
            # stream answered with a stale batch — fail loudly
            await self.close()
            raise RPCError(-32000,
                           f"batch response ids {stale_ids[:3]} match "
                           f"no request")
        if not matched and len(reqs) == 1 and len(resps) == 1 and \
                isinstance(resps[0], dict) and "error" in resps[0]:
            # JSON-RPC answers an unprocessable entry with id null: for
            # a single-element batch that error is unambiguous — surface
            # it rather than a silent None slot
            return [_err(resps[0]["error"])]
        out = []
        for req in reqs:
            r = by_id.get(req["id"], {})
            out.append(_err(r["error"]) if "error" in r
                       else r.get("result"))
        return out

    async def _post(self, body: bytes, retry_ok: bool = True):
        async with self._lock:
            # one retry on a stale reused connection (server idle-closed
            # the keep-alive socket) — but NEVER for non-idempotent
            # requests (broadcast_*): a failure after the server accepted
            # the request would silently double-send the tx.  Failures on
            # a fresh connection always propagate.
            for attempt in (0, 1):
                reused = self._conn is not None
                if not reused:
                    self._conn = await asyncio.open_connection(
                        self.host, self.port, ssl=self._ssl)
                reader, writer = self._conn
                try:
                    return await self._roundtrip(reader, writer, body)
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError):
                    await self.close()
                    if not (reused and retry_ok) or attempt:
                        raise
                except BaseException:
                    # protocol failure OR cancellation (a timed-out
                    # wait_for cancels us mid-read): the stream position
                    # is unknown, so the connection must never be reused
                    # — a stale half-read response would answer the NEXT
                    # request
                    await self.close()
                    raise

    async def _roundtrip(self, reader, writer, body: bytes):
        writer.write(
            b"POST / HTTP/1.1\r\nHost: rpc\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() +
            b"\r\n\r\n" + body)
        await writer.drain()
        status = await reader.readline()
        if not status:
            raise ConnectionResetError("server closed the connection")
        if b"200" not in status:
            raise RPCError(-32000, f"http error: {status.decode()!r}")
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = await reader.readexactly(int(headers["content-length"]))
        return json.loads(raw)


class WSClient:
    """Minimal RFC6455 client for subscribe/notification flows."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self._id = 0

    @classmethod
    async def connect(cls, host: str, port: int) -> "WSClient":
        reader, writer = await asyncio.open_connection(host, port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((
            f"GET /websocket HTTP/1.1\r\nHost: {host}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        status = await reader.readline()
        if b"101" not in status:
            raise RPCError(-32000, f"ws upgrade failed: {status.decode()!r}")
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        return cls(reader, writer)

    async def close(self) -> None:
        self.writer.close()

    async def send(self, method: str, **params) -> None:
        self._id += 1
        await self._send_frame(1, json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method,
             "params": params}).encode())

    async def recv(self) -> dict:
        while True:
            op, payload = await self._read_frame()
            if op == 8:
                raise ConnectionError("ws closed")
            if op == 9:
                await self._send_frame(10, payload)
                continue
            if op in (1, 2):
                return json.loads(payload)

    async def subscribe(self, query: str) -> None:
        await self.send("subscribe", query=query)
        resp = await self.recv()
        if "error" in resp:
            raise RPCError(-32000, str(resp["error"]))

    async def next_event(self, timeout: float = 10.0) -> dict:
        while True:
            resp = await asyncio.wait_for(self.recv(), timeout)
            if resp.get("id") is None and "result" in resp:
                return resp["result"]

    async def _send_frame(self, op: int, payload: bytes) -> None:
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        ln = len(payload)
        if ln < 126:
            hdr = bytes([0x80 | op, 0x80 | ln])
        elif ln < (1 << 16):
            hdr = bytes([0x80 | op, 0x80 | 126]) + struct.pack(">H", ln)
        else:
            hdr = bytes([0x80 | op, 0x80 | 127]) + struct.pack(">Q", ln)
        self.writer.write(hdr + mask + masked)
        await self.writer.drain()

    async def _read_frame(self) -> tuple[int, bytes]:
        hdr = await self.reader.readexactly(2)
        op = hdr[0] & 0x0F
        masked = hdr[1] & 0x80
        ln = hdr[1] & 0x7F
        if ln == 126:
            (ln,) = struct.unpack(">H", await self.reader.readexactly(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", await self.reader.readexactly(8))
        mask = await self.reader.readexactly(4) if masked else None
        data = bytearray(await self.reader.readexactly(ln))
        if mask:
            for i in range(len(data)):
                data[i] ^= mask[i % 4]
        return op, bytes(data)
