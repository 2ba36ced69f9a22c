"""Node gRPC services (counterpart of ``cometbft_tpu/rpc/grpc.py``;
reference: ``rpc/grpc/server/services/``): version, block, block
results, and the ADR-101 pruning service.

The transport is ``abci/grpc.py``'s: the port's own gRPC
(``libs/_grpc.py``), MessagePack payload frames ``{ok, result|error}``,
no protoc codegen.  The service and method names mirror the reference's
proto packages (``cometbft.services.*.v1``), so a reference user finds
the same surface, and a grpcio client of the JAX package's
``GRPCServicesClient`` reads a port node as this client reads a JAX
node.  Results are the JSON-RPC routes' (``rpc/core.py``, through
``rpc/json.py`` ``jsonable``); a value MessagePack has no type for is
sent as its ``str``, as the JAX package's ``default=str`` does.
"""

from __future__ import annotations

import itertools

from .. import __version__
from ..libs import _grpc
from ..types import _msgpack
from . import core
from .core import Environment, RPCError
from .json import jsonable

__all__ = ["GRPCServices", "GRPCServer", "GRPCServicesClient"]

_PREFIX = "cometbft.services"
_PLAIN = (type(None), bool, int, str, bytes)


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v if isinstance(v, _PLAIN) else str(v)


def _pack(obj) -> bytes:
    return _msgpack.packb(_plain(jsonable(obj)))


def _unpack(raw: bytes):
    return _msgpack.unpackb(raw) if raw else {}


class GRPCServices:
    """Routes ``/cometbft.services.<svc>.v1.<Svc>Service/<Method>`` to
    handlers over the same :class:`Environment` the JSON-RPC routes use;
    :meth:`unary_unary` and :meth:`unary_stream` are the server's method
    tables."""

    def __init__(self, node):
        self.env = Environment(node)
        self.node = node
        self._stream_ids = itertools.count(1)
        self._unary = {
            f"/{_PREFIX}.version.v1.VersionService/GetVersion":
                self._get_version,
            f"/{_PREFIX}.block.v1.BlockService/GetByHeight":
                self._get_by_height,
            f"/{_PREFIX}.block_results.v1.BlockResultsService/"
            "GetBlockResults": self._get_block_results,
            f"/{_PREFIX}.pruning.v1.PruningService/SetBlockRetainHeight":
                self._set_retain,
            f"/{_PREFIX}.pruning.v1.PruningService/GetBlockRetainHeight":
                self._get_retain,
        }
        self._streaming = {
            f"/{_PREFIX}.block.v1.BlockService/GetLatestHeight":
                self._latest_heights,
        }

    # -- handlers --------------------------------------------------------

    async def _get_version(self, req: dict) -> dict:
        return {"node": __version__, "abci": "2.0.0", "p2p": 9, "block": 11}

    async def _get_by_height(self, req: dict) -> dict:
        return await core.block(self.env, height=req.get("height"))

    async def _get_block_results(self, req: dict) -> dict:
        return await core.block_results(self.env,
                                        height=req.get("height"))

    async def _set_retain(self, req: dict) -> dict:
        return await core.set_companion_retain_height(
            self.env, height=req.get("height", 0))

    async def _get_retain(self, req: dict) -> dict:
        out = await core.retain_heights(self.env)
        return {"app_retain_height": out["app_retain_height"],
                "pruning_service_retain_height":
                    out["data_companion_retain_height"]}

    async def _latest_heights(self, req: dict):
        """Server-streaming: the committed height now, then every new one
        (reference GetLatestHeight streams from the NewBlock event).  The
        subscription goes when the client cancels or the server stops
        (the generator is closed)."""
        bus = getattr(self.node, "event_bus", None)
        store = self.env.block_store
        yield {"height": store.height()}
        if bus is None:
            return
        sid = f"grpc-latest-height-{next(self._stream_ids)}"
        sub = bus.subscribe(sid, {"tm.event": "NewBlock"})
        try:
            while True:
                msg = await sub.queue.get()
                yield {"height": msg.data["block"].header.height}
        finally:
            bus.unsubscribe(sid)

    # -- method tables ---------------------------------------------------

    def unary_unary(self) -> dict:
        def wrap(fn):
            async def handler(request: bytes) -> bytes:
                try:
                    return _pack({"ok": True,
                                  "result": await fn(_unpack(request))})
                except RPCError as e:
                    return _pack({"ok": False, "error": e.message,
                                  "code": e.code})
                except Exception as e:
                    return _pack({"ok": False, "error": repr(e)})
            return handler
        return {path: wrap(fn) for path, fn in self._unary.items()}

    def unary_stream(self) -> dict:
        def wrap(fn):
            async def handler(request: bytes):
                async for item in fn(_unpack(request)):
                    yield _pack({"ok": True, "result": item})
            return handler
        return {path: wrap(fn) for path, fn in self._streaming.items()}


class GRPCServer:
    """The node's gRPC listener (started when ``rpc.grpc_laddr`` is
    set — reference ``node/node.go`` gRPC block/pruning services)."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        self.host = host
        self.port = port
        self._server: _grpc.Server | None = None

    async def start(self) -> None:
        services = GRPCServices(self.node)
        self._server = _grpc.Server(unary_unary=services.unary_unary(),
                                    unary_stream=services.unary_stream())
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        await self._server.start()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.2)
            self._server = None


class GRPCServicesClient:
    """Client for :class:`GRPCServer` (reference
    ``rpc/grpc/client/client.go``)."""

    def __init__(self, channel: _grpc.Channel):
        self._channel = channel

    @classmethod
    async def connect(cls, host: str, port: int) -> "GRPCServicesClient":
        return cls(_grpc.insecure_channel(f"{host}:{port}"))

    async def _call(self, method: str, req: dict | None = None):
        stub = self._channel.unary_unary(method)
        frame = _unpack(await stub(_pack(req or {})))
        if not frame.get("ok", False):
            raise RPCError(frame.get("code", -32603), frame.get("error"))
        return frame["result"]

    async def get_version(self) -> dict:
        return await self._call(
            f"/{_PREFIX}.version.v1.VersionService/GetVersion")

    async def get_block_by_height(self, height: int | None = None) -> dict:
        return await self._call(
            f"/{_PREFIX}.block.v1.BlockService/GetByHeight",
            {"height": height})

    async def get_block_results(self, height: int | None = None) -> dict:
        return await self._call(
            f"/{_PREFIX}.block_results.v1.BlockResultsService/"
            "GetBlockResults", {"height": height})

    async def set_block_retain_height(self, height: int) -> dict:
        return await self._call(
            f"/{_PREFIX}.pruning.v1.PruningService/SetBlockRetainHeight",
            {"height": height})

    async def get_block_retain_height(self) -> dict:
        return await self._call(
            f"/{_PREFIX}.pruning.v1.PruningService/GetBlockRetainHeight")

    async def latest_height_stream(self):
        """The latest-height stream; closing the generator (or leaving
        its ``async for``) cancels the call at once."""
        call = self._channel.unary_stream(
            f"/{_PREFIX}.block.v1.BlockService/GetLatestHeight")(_pack({}))
        try:
            async for raw in call:
                yield _unpack(raw)["result"]
        finally:
            call.cancel()

    async def close(self) -> None:
        await self._channel.close()
