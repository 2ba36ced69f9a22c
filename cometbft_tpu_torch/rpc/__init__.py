"""The RPC surface (counterpart of ``cometbft_tpu/rpc``): the JSON-RPC,
URI and WebSocket server with its routes, and the HTTP and WebSocket
clients, and inspect mode (``rpc/inspect.py``: the routes over a stopped
node's home).  The node's gRPC services are ``rpc/grpc.py``."""

from .client import HTTPClient, WSClient
from .core import ROUTES, Environment, RPCError
from .server import RPCServer, parse_query

__all__ = ["RPCServer", "HTTPClient", "WSClient", "Environment", "ROUTES",
           "RPCError", "parse_query"]
