"""Light-client RPC proxy (counterpart of ``cometbft_tpu/light/proxy.py``):
an RPC endpoint whose answers are VERIFIED against the trusted header
chain before being returned (reference: ``light/proxy/proxy.go`` and the
``cometbft light`` daemon).

A wallet pointing at this proxy gets full-node convenience with
light-client trust: headers/commits/validators come from the light
client's verification pipeline, and blocks fetched from the primary are
only returned when their hash matches the verified header."""

from __future__ import annotations

import asyncio

from ..crypto.merkle import ProofOp, ProofOpError, ProofOperators
from ..rpc.core import RPCError, paginate_validators
from ..rpc.json import from_jsonable, jsonable
from ..rpc.server import RPCServer
from ..types import codec
from ..types.block_id import BlockID
from ..types.part_set import PartSet
from .client import Client
from .provider import ErrLightBlockNotFound
from .types import LightClientError

__all__ = ["LightProxy", "PROXY_ROUTES", "run_light_proxy",
           "CODE_NOT_YET_AVAILABLE"]


class LightProxy:
    """The 'node' the RPC server wraps: routes resolve against a light
    client instead of local stores."""

    def __init__(self, client: Client, primary_rpc):
        self.client = client
        self.primary_rpc = primary_rpc     # HTTPClient to the full node
        self.event_bus = None
        self.name = "light-proxy"


CODE_NOT_YET_AVAILABLE = -32001      # retryable: chain hasn't caught up


async def _lb(env, height) -> "tuple":
    proxy: LightProxy = env.node
    try:
        if height in (None, 0, "0", ""):
            lb = await proxy.client.update()
            if lb is None:
                lb = proxy.client.latest_trusted()
        else:
            lb = await proxy.client.verify_light_block_at_height(
                int(height))
    except ErrLightBlockNotFound as e:
        # benign: the primary simply doesn't have that height yet
        raise RPCError(CODE_NOT_YET_AVAILABLE, str(e))
    except LightClientError as e:
        raise RPCError(-32603, f"light verification failed: {e}")
    if lb is None:
        raise RPCError(-32603, "no trusted block available")
    return lb


async def status(env) -> dict:
    proxy: LightProxy = env.node
    latest = proxy.client.latest_trusted()
    return {
        "node_info": {"moniker": proxy.name,
                      "network": proxy.client.chain_id},
        "sync_info": {
            "latest_block_height": latest.height if latest else 0,
            "latest_block_hash":
                latest.header.hash().hex() if latest else "",
            "trusted": True,
        },
    }


async def header(env, height=None) -> dict:
    lb = await _lb(env, height)
    return {"header": jsonable(lb.header), "verified": True}


async def commit(env, height=None) -> dict:
    lb = await _lb(env, height)
    return {"header": jsonable(lb.header), "commit": jsonable(lb.commit),
            "canonical": True, "verified": True}


async def validators(env, height=None, page=1, per_page=30) -> dict:
    """Same shape + pagination as the full-node route (a light client can
    point at a light proxy)."""
    lb = await _lb(env, height)
    out = paginate_validators(lb.validators, lb.height, page, per_page)
    out["verified"] = True
    return out


async def block(env, height=None) -> dict:
    """Fetch the full block from the primary, admit it only if its hash
    matches the VERIFIED header (proxy.go block verification)."""
    proxy: LightProxy = env.node
    lb = await _lb(env, height)
    res = await proxy.primary_rpc.call("block", height=lb.height)
    blk = from_jsonable(res["block"])
    if blk.hash() != lb.header.hash():
        raise RPCError(-32603,
                       "primary served a block that does not match the "
                       "verified header (possible attack)")
    # NEVER echo the primary's block_id: recompute it from the verified
    # block so a forged id can't ride a valid body (light/rpc/client.go
    # Block checks BlockID.Hash too)
    parts = PartSet.from_data(codec.pack(blk))
    bid = BlockID(blk.hash(), parts.header())
    return {"block_id": jsonable(bid), "block": res["block"],
            "verified": True}


async def abci_query(env, path="", data=None, height=0) -> dict:
    """Verified state query: fetch value + merkle proof from the primary,
    check the proof chain against the app hash in the VERIFIED header at
    height+1 (light/rpc/client.go ABCIQueryWithOptions with prove=true —
    the wallet-grade query flow)."""
    proxy: LightProxy = env.node
    raw = bytes.fromhex(data) if isinstance(data, str) else (data or b"")
    res = await proxy.primary_rpc.call("abci_query", path=path,
                                       data=raw.hex(), height=int(height),
                                       prove=True)
    r = res["response"]
    if r["code"] != 0 or not r["value"]:
        raise RPCError(-32603,
                       f"query failed or empty (cannot verify): {r['log']}")
    if not r["proof_ops"]:
        raise RPCError(-32603, "primary returned no proof")
    q_height = r["height"]
    # app hash AFTER q_height lives in header q_height+1, which may not be
    # committed for another block interval: retry briefly
    lb = None
    for _ in range(25):
        try:
            lb = await _lb(env, q_height + 1)
            break
        except RPCError as e:
            if e.code != CODE_NOT_YET_AVAILABLE:
                raise            # a verification FAILURE is an attack signal
            await asyncio.sleep(0.2)
    if lb is None:
        raise RPCError(-32603,
                       f"header {q_height + 1} not yet available to "
                       "verify the query against")
    try:
        ops = ProofOperators.decode(
            [ProofOp(op["type"], bytes.fromhex(op["key"]),
                     bytes.fromhex(op["data"]))
             for op in r["proof_ops"]])
        ops.verify(lb.header.app_hash, [raw], bytes.fromhex(r["value"]))
    except ProofOpError as e:
        raise RPCError(-32603, f"proof verification FAILED: {e}")
    return {"response": r, "verified": True}


async def health(env) -> dict:
    return {}


PROXY_ROUTES = {
    "health": health,
    "status": status,
    "header": header,
    "commit": commit,
    "validators": validators,
    "block": block,
    "abci_query": abci_query,
}


async def run_light_proxy(client: Client, primary_rpc,
                          host: str = "127.0.0.1", port: int = 0):
    """Start the verified-RPC proxy; returns (server, (host, port))."""
    server = RPCServer(LightProxy(client, primary_rpc),
                       routes=PROXY_ROUTES)
    addr = await server.listen(host, port)
    return server, addr
