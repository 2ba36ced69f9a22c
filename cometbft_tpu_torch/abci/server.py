"""ABCI socket server for out-of-process applications (counterpart of
``cometbft_tpu/abci/server.py``; reference:
``abci/server/socket_server.go``): over TCP, or over a unix socket with
``unix_path``.  The frames are ``abci/client.py``'s, so a JAX
``SocketClient`` is served as a port one is."""

from __future__ import annotations

import asyncio

from .application import Application
from .client import (dispatch_to_app, read_frame, write_frame,
                     _decode_value, _encode_value)

__all__ = ["ABCIServer"]


class ABCIServer:
    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 26658, unix_path: str | None = None):
        self.app = app
        self.host = host
        self.port = port
        self.unix_path = unix_path
        self._server: asyncio.AbstractServer | None = None
        self._lock = asyncio.Lock()      # app calls serialized like local

    async def start(self) -> None:
        if self.unix_path:
            self._server = await asyncio.start_unix_server(
                self._handle, path=self.unix_path)
        else:
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                rid = frame["id"]
                try:
                    params = {k: _decode_value(v)
                              for k, v in frame["params"].items()}
                    async with self._lock:
                        result = await dispatch_to_app(
                            self.app, frame["method"], params)
                    write_frame(writer, {"id": rid, "ok": True,
                                         "result": _encode_value(result)})
                except Exception as e:  # app errors propagate to the client
                    write_frame(writer, {"id": rid, "ok": False,
                                         "error": repr(e)})
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
