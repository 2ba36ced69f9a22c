"""ABCI over gRPC (counterpart of ``cometbft_tpu/abci/grpc.py``;
reference: ``abci/client/grpc_client.go`` + ``abci/server/grpc_server.go``).

One unary RPC per ABCI method on ``cometbft.abci.v1.ABCIService`` (the
reference's service shape), over the port's own HTTP/2 and gRPC
(``libs/_grpc.py``).  Payloads are the socket transport's MessagePack
frames (``types/_msgpack.py``, with dataclass values as
``abci/client.py`` ``_encode_value`` maps), carried as raw message
bytes, so a port client talks to the JAX package's ``GRPCABCIServer``
and a grpcio client to this one.
"""

from __future__ import annotations

import asyncio

from ..libs import _grpc
from ..types import _msgpack
from .application import Application
from .client import (ABCIClient, ABCIClientError, _decode_value,
                     _encode_value, dispatch_to_app)

__all__ = ["SERVICE", "GRPCABCIServer", "GRPCClient"]

SERVICE = "cometbft.abci.v1.ABCIService"

# snake_case dispatch names <-> CamelCase wire method names
_METHODS = [
    "echo", "info", "query", "check_tx", "init_chain",
    "prepare_proposal", "process_proposal", "finalize_block",
    "extend_vote", "verify_vote_extension", "commit",
    "list_snapshots", "offer_snapshot", "load_snapshot_chunk",
    "apply_snapshot_chunk", "flush",
]


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))


def _handler(app: Application, lock: asyncio.Lock, method: str):
    async def handle(request: bytes) -> bytes:
        try:
            params = {k: _decode_value(v)
                      for k, v in _msgpack.unpackb(request).items()}
            # app calls serialised like the socket server's lock
            async with lock:
                if method == "flush":
                    result = None
                else:
                    result = await dispatch_to_app(app, method, params)
            return _msgpack.packb({"ok": True,
                                   "result": _encode_value(result)})
        except Exception as e:  # app errors propagate to the client
            return _msgpack.packb({"ok": False, "error": repr(e)})

    return handle


class GRPCABCIServer:
    """Serves an :class:`Application` over gRPC
    (``abci/server/grpc_server.go``)."""

    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._server: _grpc.Server | None = None

    async def start(self) -> None:
        lock = asyncio.Lock()
        self._server = _grpc.Server(unary_unary={
            f"/{SERVICE}/{_camel(m)}": _handler(self.app, lock, m)
            for m in _METHODS})
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        await self._server.start()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.2)
            self._server = None


class GRPCClient(ABCIClient):
    """gRPC ABCI client (``abci/client/grpc_client.go``): one HTTP/2
    channel, its calls multiplexed as streams (no request queue or id
    map, unlike the socket client).  A transport failure raises
    ``ABCIClientError("grpc transport error: <code>: <details>")``; the
    next call connects again."""

    def __init__(self, channel: _grpc.Channel):
        self._channel = channel
        self._stubs = {
            m: channel.unary_unary(f"/{SERVICE}/{_camel(m)}")
            for m in _METHODS
        }

    @classmethod
    async def connect(cls, host: str = "127.0.0.1",
                      port: int = 26658) -> "GRPCClient":
        return cls(_grpc.insecure_channel(f"{host}:{port}"))

    async def call(self, method: str, **params):
        stub = self._stubs.get(method)
        if stub is None:
            raise ABCIClientError(f"unknown ABCI method {method!r}")
        try:
            raw = await stub(_msgpack.packb(_encode_value(params)))
        except _grpc.RpcError as e:
            raise ABCIClientError(
                f"grpc transport error: {e.code()}: {e.details()}") from e
        frame = _msgpack.unpackb(raw)
        if not frame.get("ok", False):
            raise ABCIClientError(frame.get("error"))
        return _decode_value(frame["result"])

    async def close(self) -> None:
        await self._channel.close()
