"""TCP transport with connection upgrade (counterpart of
``cometbft_tpu/p2p/transport.py``; reference:
``p2p/transport.go:137,194,212,410`` MultiplexTransport).

Upgrade sequence on every raw TCP connection, dialed or accepted:
SecretConnection handshake (authenticated encryption) -> NodeInfo exchange
-> validation (declared id matches the handshake-proven pubkey,
compatibility).  Only then does the Switch see the peer.  The handshake
checks the peer's challenge signature on the transport's ``device``
(None: CUDA, raising without a card at construction; ``"cpu"``: the
kernels' plain versions).  With a ``fuzz_config``
(``p2p/fuzz.FuzzConnConfig``) every raw stream pair, dialed or accepted,
is wrapped by the connection fuzzer before the upgrade
(``p2p/transport.go:223``).
"""

from __future__ import annotations

import asyncio
import time

from ..crypto import plan as _plan
from ..libs import clock
from .fuzz import fuzz_streams
from .key import NodeKey, node_id
from .metrics import p2p_metrics
from .node_info import NodeInfo, NodeInfoError
from .secret_connection import SecretConnection, handshake

HANDSHAKE_TIMEOUT = 8.0


class TransportError(Exception):
    pass


class Transport:
    def __init__(self, node_key: NodeKey, node_info_fn, device=None,
                 fuzz_config=None):
        _plan.resolve_devices(device)          # raises without a card
        self.node_key = node_key
        self.node_info_fn = node_info_fn      # () -> NodeInfo (fresh copy)
        self.device = device
        self.fuzz_config = fuzz_config        # p2p.fuzz.FuzzConnConfig
        self._server: asyncio.AbstractServer | None = None
        self.listen_addr: str | None = None
        self.on_accept = None   # async (SecretConnection, NodeInfo) -> None
        # accepted connections still in their upgrade, closed by close()
        self._accepting: set[asyncio.Task] = set()

    def _maybe_fuzz(self, reader, writer):
        if self.fuzz_config is None:
            return reader, writer
        return fuzz_streams(reader, writer, self.fuzz_config)

    # ------------------------------------------------------------- listen

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._server = await asyncio.start_server(
            self._handle_accept, host, port)
        sock = self._server.sockets[0]
        addr = sock.getsockname()
        self.listen_addr = f"{addr[0]}:{addr[1]}"
        return self.listen_addr

    async def _handle_accept(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._accepting.add(task)
        try:
            try:
                freader, fwriter = self._maybe_fuzz(reader, writer)
                conn, ni = await self._timed_upgrade(freader, fwriter,
                                                     "inbound")
            except asyncio.CancelledError:
                writer.close()
                raise
            except Exception:
                writer.close()
                return
            if self.on_accept is not None:
                await self.on_accept(conn, ni)
        finally:
            self._accepting.discard(task)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._accepting):
                task.cancel()
            await self._server.wait_closed()
            self._server = None

    # --------------------------------------------------------------- dial

    async def dial(self, addr: str) -> tuple[SecretConnection, NodeInfo]:
        host, port = addr.removeprefix("tcp://").rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            freader, fwriter = self._maybe_fuzz(reader, writer)
            return await self._timed_upgrade(freader, fwriter, "outbound")
        except BaseException:
            writer.close()
            raise

    # ------------------------------------------------------------ upgrade

    async def _timed_upgrade(self, reader, writer, direction: str) \
            -> tuple[SecretConnection, NodeInfo]:
        """The upgrade under its timeout, metered: handshake latency by
        direction on success, a failure counter otherwise (an operator
        watching a validator fail to join a network sees WHERE — dials
        that never complete the upgrade, or inbound peers that do not)."""
        mets = p2p_metrics()
        node = self.node_key.id[:8]
        t0 = time.perf_counter()
        try:
            out = await clock.wait_for(
                self._upgrade(reader, writer), HANDSHAKE_TIMEOUT)
        except asyncio.CancelledError:
            raise                 # shutdown, not a handshake failure
        except Exception:
            mets.handshake_failures.inc(direction=direction, node=node)
            raise
        mets.handshake_seconds.observe(time.perf_counter() - t0,
                                       direction=direction, node=node)
        return out

    async def _upgrade(self, reader, writer) \
            -> tuple[SecretConnection, NodeInfo]:
        conn = await handshake(reader, writer, self.node_key.priv_key,
                               self.device)
        await conn.write_msg(self.node_info_fn().encode())
        their_info = NodeInfo.decode(await conn.read_msg(max_size=10240))
        their_info.validate_basic()
        proven_id = node_id(conn.remote_pub_key)
        if their_info.node_id != proven_id:
            raise TransportError(
                f"peer declared id {their_info.node_id} but proved "
                f"{proven_id}")
        try:
            self.node_info_fn().compatible_with(their_info)
        except NodeInfoError as e:
            raise TransportError(f"incompatible peer: {e}")
        return conn, their_info
