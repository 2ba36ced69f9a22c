"""ABCI clients (counterpart of ``cometbft_tpu/abci/client.py``;
reference: ``abci/client/``): the ``ABCIClient`` interface (one
awaitable method per ABCI call), the method dispatch shared with the
socket server (:func:`dispatch_to_app`), the in-process client, and the
pipelined socket client (``abci/client/socket_client.go``).

Socket frames are the JAX package's bytes: a ``>I`` length, then
MessagePack of ``{id, method, params}`` or ``{id, ok, result|error}``
(packed with ``types/_msgpack.py``), with dataclass values as
``{"__dc__": name, field: value, ...}`` maps (:func:`_encode_value`,
:func:`_decode_value`), the encoding the block executor also stores a
FinalizeBlock response with.  A port client talks to a JAX
``ABCIServer`` and the reverse.
"""

from __future__ import annotations

import asyncio
import itertools
import struct
from abc import ABC, abstractmethod
from dataclasses import fields, is_dataclass

from ..types import _msgpack
from ..types import params as _params
from . import types as t
from .application import Application

__all__ = ["ABCIClientError", "ABCIClient", "dispatch_to_app",
           "LocalClient", "SocketClient", "read_frame", "write_frame"]

_LEN = struct.Struct(">I")


class ABCIClientError(Exception):
    pass


class ABCIClient(ABC):
    """One method per ABCI call; all awaitable."""

    @abstractmethod
    async def call(self, method: str, **params): ...

    async def echo(self, msg: str):
        return await self.call("echo", msg=msg)

    async def info(self) -> t.InfoResponse:
        return await self.call("info")

    async def query(self, path: str, data: bytes, height: int = 0,
                    prove: bool = False) -> t.QueryResponse:
        return await self.call("query", path=path, data=data, height=height,
                               prove=prove)

    async def check_tx(self, tx: bytes, recheck: bool = False
                       ) -> t.CheckTxResponse:
        return await self.call("check_tx", tx=tx, recheck=recheck)

    async def init_chain(self, req: t.InitChainRequest) -> t.InitChainResponse:
        return await self.call("init_chain", req=req)

    async def prepare_proposal(self, req: t.PrepareProposalRequest
                               ) -> t.PrepareProposalResponse:
        return await self.call("prepare_proposal", req=req)

    async def process_proposal(self, req: t.ProcessProposalRequest) -> int:
        return await self.call("process_proposal", req=req)

    async def finalize_block(self, req: t.FinalizeBlockRequest
                             ) -> t.FinalizeBlockResponse:
        return await self.call("finalize_block", req=req)

    async def extend_vote(self, height: int, round_: int, block_hash: bytes
                          ) -> t.ExtendVoteResponse:
        return await self.call("extend_vote", height=height, round_=round_,
                               block_hash=block_hash)

    async def verify_vote_extension(self, height: int, round_: int,
                                    validator_address: bytes,
                                    block_hash: bytes, extension: bytes
                                    ) -> t.VerifyVoteExtensionResponse:
        return await self.call("verify_vote_extension", height=height,
                               round_=round_,
                               validator_address=validator_address,
                               block_hash=block_hash, extension=extension)

    async def commit(self) -> t.CommitResponse:
        return await self.call("commit")

    async def list_snapshots(self) -> list[t.Snapshot]:
        return await self.call("list_snapshots")

    async def offer_snapshot(self, snapshot: t.Snapshot,
                             app_hash: bytes) -> int:
        return await self.call("offer_snapshot", snapshot=snapshot,
                               app_hash=app_hash)

    async def load_snapshot_chunk(self, height: int, format_: int,
                                  chunk: int) -> bytes:
        return await self.call("load_snapshot_chunk", height=height,
                               format_=format_, chunk=chunk)

    async def apply_snapshot_chunk(self, index: int, chunk: bytes,
                                   sender: str) -> int:
        return await self.call("apply_snapshot_chunk", index=index,
                               chunk=chunk, sender=sender)

    async def close(self) -> None:
        pass


async def dispatch_to_app(app: Application, method: str, params: dict):
    """The method dispatch of the local client and the socket server."""
    if method == "echo":
        return params["msg"]
    if method == "query":
        return await app.query(params["path"], params["data"],
                               params["height"], params["prove"])
    if method == "check_tx":
        return await app.check_tx(params["tx"], params["recheck"])
    if method == "extend_vote":
        return await app.extend_vote(params["height"], params["round_"],
                                     params["block_hash"])
    if method == "verify_vote_extension":
        return await app.verify_vote_extension(
            params["height"], params["round_"],
            params["validator_address"], params["block_hash"],
            params["extension"])
    if method == "load_snapshot_chunk":
        return await app.load_snapshot_chunk(params["height"],
                                             params["format_"],
                                             params["chunk"])
    if method == "apply_snapshot_chunk":
        return await app.apply_snapshot_chunk(params["index"],
                                              params["chunk"],
                                              params["sender"])
    if method == "offer_snapshot":
        return await app.offer_snapshot(params["snapshot"],
                                        params["app_hash"])
    if method in ("info", "commit", "list_snapshots"):
        return await getattr(app, method)()
    if method in ("init_chain", "prepare_proposal", "process_proposal",
                  "finalize_block"):
        return await getattr(app, method)(params["req"])
    raise ABCIClientError(f"unknown ABCI method {method!r}")


class LocalClient(ABCIClient):
    """In-process client (``abci/client/local_client.go``): one lock
    serialises the calls, as the reference's mutex does."""

    def __init__(self, app: Application):
        self.app = app
        self._lock = asyncio.Lock()

    async def call(self, method: str, **params):
        async with self._lock:
            return await dispatch_to_app(self.app, method, params)


# field names per dataclass type (False: not a dataclass), so a value is
# not reflected on every call
_DC_FIELDS: dict[type, tuple | bool] = {}


def _encode_value(v):
    """Dataclasses as ``{"__dc__": name, field: value, ...}`` maps, level
    by level, so nested dataclasses keep their own tags."""
    tp = type(v)
    names = _DC_FIELDS.get(tp)
    if names is None:
        names = tuple(f.name for f in fields(v)) \
            if is_dataclass(v) and not isinstance(v, type) else False
        _DC_FIELDS[tp] = names
    if names is not False:
        out = {"__dc__": tp.__name__}
        for n in names:
            out[n] = _encode_value(getattr(v, n))
        return out
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def _domain_types():
    """The domain types inside ABCI requests: the commit and extended
    commit trees of PrepareProposal.local_last_commit and
    FinalizeBlock.decided_last_commit."""
    from ..types.block_id import BlockID, PartSetHeader
    from ..types.commit import (Commit, CommitSig, ExtendedCommit,
                                ExtendedCommitSig)

    return (BlockID, PartSetHeader, Commit, CommitSig, ExtendedCommit,
            ExtendedCommitSig)


_DC_TYPES = {cls.__name__: cls for cls in (
    t.EventAttribute, t.Event, t.ExecTxResult, t.ValidatorUpdate,
    t.Misbehavior, t.Snapshot, t.InfoResponse, t.QueryResponse,
    t.CheckTxResponse, t.InitChainRequest, t.InitChainResponse,
    t.PrepareProposalRequest, t.PrepareProposalResponse,
    t.ProcessProposalRequest, t.FinalizeBlockRequest,
    t.FinalizeBlockResponse, t.ExtendVoteResponse,
    t.VerifyVoteExtensionResponse, t.CommitResponse,
    t.ApplySnapshotChunkResponse,
    _params.ConsensusParams, _params.BlockParams, _params.EvidenceParams,
    _params.ValidatorParams, _params.VersionParams, _params.FeatureParams,
    _params.SynchronyParams) + _domain_types()}


def _decode_value(v):
    if isinstance(v, dict) and "__dc__" in v:
        name = v.pop("__dc__")
        cls = _DC_TYPES[name]
        return cls(**{k: _decode_value(x) for k, x in v.items()})
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


async def read_frame(reader: asyncio.StreamReader):
    hdr = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(hdr)
    return _msgpack.unpackb(await reader.readexactly(n))


def write_frame(writer: asyncio.StreamWriter, obj) -> None:
    """One frame of ``obj``, whose values are already encoded
    (:func:`_encode_value`)."""
    raw = _msgpack.packb(obj)
    writer.write(_LEN.pack(len(raw)) + raw)


class SocketClient(ABCIClient):
    """Pipelined socket client (``abci/client/socket_client.go``):
    requests stream out with sequence ids, and a reader task resolves
    their futures.  A lost connection fails every pending and later
    call with :class:`ABCIClientError`; nothing falls back to a local
    app."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._seq = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._reader_task = asyncio.create_task(self._read_loop())
        self._err: Exception | None = None

    @classmethod
    async def connect(cls, host: str = "127.0.0.1", port: int = 26658,
                      unix_path: str | None = None) -> "SocketClient":
        if unix_path:
            reader, writer = await asyncio.open_unix_connection(unix_path)
        else:
            reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def _read_loop(self):
        try:
            while True:
                frame = await read_frame(self.reader)
                fut = self._pending.pop(frame["id"], None)
                if fut is None or fut.done():
                    continue
                if frame.get("ok", False):
                    fut.set_result(_decode_value(frame["result"]))
                else:
                    fut.set_exception(ABCIClientError(frame.get("error")))
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError) as e:
            self._err = ABCIClientError(f"connection lost: {e!r}")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(self._err)
            self._pending.clear()

    async def call(self, method: str, **params):
        if self._err:
            raise self._err
        rid = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        # the read loop may have died between the check and the
        # registration: a future must not be stranded
        if self._err or self._reader_task.done():
            self._pending.pop(rid, None)
            raise self._err or ABCIClientError("connection closed")
        write_frame(self.writer, {"id": rid, "method": method,
                                  "params": _encode_value(params)})
        await self.writer.drain()
        return await fut

    async def close(self):
        self._reader_task.cancel()
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except Exception:
            pass
