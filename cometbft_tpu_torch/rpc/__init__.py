"""The RPC surface (counterpart of ``cometbft_tpu/rpc``): the JSON-RPC,
URI and WebSocket server with its routes, and the HTTP and WebSocket
clients.  gRPC (``rpc/grpc.py``) needs ``grpc`` and is not ported;
``rpc/inspect.py`` comes with the storage doctor."""

from .client import HTTPClient, WSClient
from .core import ROUTES, Environment, RPCError
from .server import RPCServer, parse_query

__all__ = ["RPCServer", "HTTPClient", "WSClient", "Environment", "ROUTES",
           "RPCError", "parse_query"]
