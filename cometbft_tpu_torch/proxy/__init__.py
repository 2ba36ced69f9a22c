"""AppConns: four logical ABCI connections (counterpart of
``cometbft_tpu/proxy``; reference: ``proxy/multi_app_conn.go``:
consensus, mempool, query, snapshot)."""

from .multi_app_conn import (AppConns, ClientCreator, TracedAppConn,
                             local_client_creator)

__all__ = ["AppConns", "ClientCreator", "TracedAppConn",
           "local_client_creator"]
