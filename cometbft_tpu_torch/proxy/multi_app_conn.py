"""Multiplexed application connections (counterpart of
``cometbft_tpu/proxy/multi_app_conn.py``; reference: ``proxy/``).

The reference maintains four logical connections (consensus, mempool,
query, snapshot — ``proxy/multi_app_conn.go``) so mempool CheckTx traffic
can't head-of-line-block consensus.  Here each logical connection is its own
client instance (its own lock, socket or gRPC channel), produced by a
ClientCreator (``proxy/client.go:16`` analogue): in process, over the
ABCI socket (:func:`socket_client_creator`) or over gRPC
(:func:`grpc_client_creator`).
"""

from __future__ import annotations

import functools
import time
from typing import Awaitable, Callable

from ..abci.application import Application
from ..abci.client import ABCIClient, LocalClient, SocketClient
from ..abci.grpc import GRPCClient
from ..libs import tracing

__all__ = ["ClientCreator", "TracedAppConn", "local_client_creator",
           "socket_client_creator", "grpc_client_creator", "AppConns"]

ClientCreator = Callable[[], Awaitable[ABCIClient]]


@functools.cache
def _abci_metrics():
    from ..libs import metrics as m

    return m.histogram(
        "abci_call_seconds",
        "application call latency by logical connection and method "
        "(a slow FinalizeBlock on the consensus connection IS commit "
        "latency; a slow CheckTx on the mempool connection stalls "
        "admission)")


class TracedAppConn(ABCIClient):
    """Per-connection latency shim around a real ABCI client: every call
    lands in ``abci_call_seconds{conn,method}`` and, when tracing is on,
    a flight-recorder span — so a height timeline shows exactly how long
    the app held the consensus connection inside the commit step."""

    def __init__(self, inner: ABCIClient, conn: str, node: str = ""):
        self._inner = inner
        self._conn = conn
        self._node = node
        self._hist = _abci_metrics()

    async def call(self, method: str, **params):
        t0 = time.perf_counter()
        sp = None
        if tracing.is_enabled():
            # height attribution for the timeline: request-object calls
            # (FinalizeBlock, PrepareProposal, ...) carry it on ``req``,
            # flat calls (query, extend_vote) pass it directly
            h = params.get("height")
            if h is None:
                h = getattr(params.get("req"), "height", None)
            sp = tracing.begin("abci", "call", conn=self._conn,
                               method=method, height=h, node=self._node)
        try:
            return await self._inner.call(method, **params)
        finally:
            self._hist.observe(time.perf_counter() - t0,
                               conn=self._conn, method=method)
            tracing.finish(sp)

    async def close(self) -> None:
        await self._inner.close()


def local_client_creator(app: Application) -> ClientCreator:
    """All four connections share the app; each gets its own lock —
    UNSYNCED local semantics per connection, serialized within one."""

    async def create() -> ABCIClient:
        return LocalClient(app)

    return create


def socket_client_creator(host: str = "127.0.0.1", port: int = 26658,
                          unix_path: str | None = None) -> ClientCreator:
    """Each connection its own socket to an ``abci/server.ABCIServer``;
    an unreachable server raises from :meth:`AppConns.start`."""

    async def create() -> ABCIClient:
        return await SocketClient.connect(host, port, unix_path)

    return create


def grpc_client_creator(host: str = "127.0.0.1",
                        port: int = 26658) -> ClientCreator:
    """Remote app over gRPC (``proxy/client.go`` grpc creator); each
    connection its own channel to an ``abci/grpc.GRPCABCIServer``.  A
    channel connects at its first call, so an unreachable server raises
    from the handshake's first call, not from :meth:`AppConns.start`."""

    async def create() -> ABCIClient:
        return await GRPCClient.connect(host, port)

    return create


class AppConns:
    def __init__(self, creator: ClientCreator, node: str = ""):
        self._creator = creator
        self._node = node
        self.consensus: ABCIClient | None = None
        self.mempool: ABCIClient | None = None
        self.query: ABCIClient | None = None
        self.snapshot: ABCIClient | None = None

    async def start(self) -> None:
        self.consensus = TracedAppConn(await self._creator(), "consensus",
                                       self._node)
        self.mempool = TracedAppConn(await self._creator(), "mempool",
                                     self._node)
        self.query = TracedAppConn(await self._creator(), "query",
                                   self._node)
        self.snapshot = TracedAppConn(await self._creator(), "snapshot",
                                      self._node)

    async def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            if c is not None:
                await c.close()
