"""Remote signer (counterpart of ``cometbft_tpu/privval/signer.py``): keep
the validator key in a separate process (HSM stand-in) and sign over a
socket (reference: ``privval/signer_client.go:17``
SignerClient, ``privval/signer_server.go`` SignerServer, message schema in
``privval/msgs.go``).

SignerServer listens on TCP/UNIX and serves a wrapped PrivValidator
(normally a FilePV); SignerClient implements PrivValidator for the node
side.  Messages are length-prefixed msgpackRequest/Response,
SignVoteRequest/SignedVoteResponse, SignProposalRequest/
SignedProposalResponse, Ping/Pong; errors travel as {"err": ...} replies
(remoteSignerError).  The frames are the JAX package's bytes, packed
with ``types/_msgpack.py``: a port listener serves a JAX signer and the
reverse.  A signer that does not dial in raises
(:class:`RemoteSignerError`) and a round trip past its deadline times
out (:class:`SignerTimeoutError`); nothing falls back to a file
signer."""

from __future__ import annotations

import asyncio
import functools
import struct

from ..crypto.keys import ED25519_KEY_TYPE, pub_key_from_type_bytes
from ..libs import failures
from ..types import _msgpack, codec
from ..types.priv_validator import PrivValidator
from ..types.vote import Proposal, Vote

__all__ = ["RemoteSignerError", "SignerTimeoutError", "SignerServer",
           "SignerClient", "SignerListener", "serve_dialer",
           "DEFAULT_ROUND_TRIP_TIMEOUT_S"]

_LEN = struct.Struct("<I")
MAX_MSG = 1 << 20
# default bound on one signer round trip (config base.priv_validator_
# timeout_s overrides; 0 disables).  A wedged signer process used to
# block consensus FOREVER — with the deadline it costs one missed vote
# and a reconnect instead.
DEFAULT_ROUND_TRIP_TIMEOUT_S = 5.0


class RemoteSignerError(Exception):
    pass


class SignerTimeoutError(RemoteSignerError):
    """One round trip exceeded the deadline: the signer is wedged or the
    link is black-holing.  The listener treats this exactly like a
    dropped connection (close + re-accept the signer's redial)."""


@functools.cache
def _signer_metrics():
    from ..libs import metrics as m

    return m.counter("privval_signer_timeouts_total",
                     "remote-signer round trips abandoned on deadline")


async def _send(writer: asyncio.StreamWriter, obj: dict) -> None:
    raw = _msgpack.packb(obj)
    writer.write(_LEN.pack(len(raw)) + raw)
    await writer.drain()


async def _recv(reader: asyncio.StreamReader) -> dict:
    hdr = await reader.readexactly(_LEN.size)
    (ln,) = _LEN.unpack(hdr)
    if ln > MAX_MSG:
        raise RemoteSignerError(f"oversized signer message: {ln}")
    return _msgpack.unpackb(await reader.readexactly(ln))


class SignerServer:
    """Serves a PrivValidator's signing operations to one or more nodes."""

    def __init__(self, pv: PrivValidator):
        self.pv = pv
        self._server: asyncio.Server | None = None

    async def listen(self, host: str = "127.0.0.1",
                     port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._serve, host, port)
        addr = self._server.sockets[0].getsockname()
        return addr[0], addr[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await _recv(reader)
                await _send(writer, await self._handle(req))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _handle(self, req: dict) -> dict:
        tag = req.get("@")
        try:
            if tag == "ping":
                return {"@": "pong"}
            if tag == "pubkey_req":
                pub = self.pv.get_pub_key()
                return {"@": "pubkey_res", "pub": pub.bytes(),
                        "type": pub.type()}
            if tag == "sign_vote_req":
                vote: Vote = codec.from_dict(req["vote"])
                await self.pv.sign_vote(req["chain_id"], vote,
                                        sign_extension=req["ext"])
                return {"@": "signed_vote_res", "vote": codec.to_dict(vote)}
            if tag == "sign_proposal_req":
                prop: Proposal = codec.from_dict(req["proposal"])
                await self.pv.sign_proposal(req["chain_id"], prop)
                return {"@": "signed_proposal_res",
                        "proposal": codec.to_dict(prop)}
            return {"@": "err", "msg": f"unknown request {tag!r}"}
        except Exception as e:  # sign errors ride back as err frames
            return {"@": "err", "msg": f"{type(e).__name__}: {e}"}


class SignerClient(PrivValidator):
    """Node-side PrivValidator backed by a remote SignerServer."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, pub_key,
                 timeout_s: float = DEFAULT_ROUND_TRIP_TIMEOUT_S):
        self._reader = reader
        self._writer = writer
        self._pub_key = pub_key
        self._lock = asyncio.Lock()      # one in-flight request at a time
        self.timeout_s = timeout_s

    @classmethod
    async def connect(cls, host: str, port: int,
                      timeout_s: float = DEFAULT_ROUND_TRIP_TIMEOUT_S
                      ) -> "SignerClient":
        reader, writer = await asyncio.open_connection(host, port)
        return await cls.from_streams(reader, writer, timeout_s=timeout_s)

    @classmethod
    async def from_streams(cls, reader, writer,
                           timeout_s: float = DEFAULT_ROUND_TRIP_TIMEOUT_S
                           ) -> "SignerClient":
        """Handshake over an already-open connection (either dial
        direction ends up here)."""
        await _send(writer, {"@": "pubkey_req"})
        res = await _recv(reader)
        if res.get("@") != "pubkey_res":
            raise RemoteSignerError(f"bad pubkey response: {res}")
        pub = pub_key_from_type_bytes(res.get("type", ED25519_KEY_TYPE),
                                      res["pub"])
        return cls(reader, writer, pub, timeout_s=timeout_s)

    async def close(self) -> None:
        self._writer.close()

    async def _round_trip(self, req: dict) -> dict:
        """One request/response, bounded by ``timeout_s`` (covering lock
        wait, send, and receive: a request wedged behind another wedged
        request must time out too, not queue forever)."""

        async def go() -> dict:
            async with self._lock:
                fired = failures.fire("signer.round_trip.hang")
                if fired is not None:
                    # chaos: the signer process is wedged — nothing comes
                    # back until (long after) the deadline
                    await asyncio.sleep(float(fired.get("delay", 3600.0)))
                await _send(self._writer, req)
                return await _recv(self._reader)

        if self.timeout_s and self.timeout_s > 0:
            try:
                res = await asyncio.wait_for(go(), self.timeout_s)
            except asyncio.TimeoutError:
                _signer_metrics().inc()
                raise SignerTimeoutError(
                    f"remote signer did not answer within "
                    f"{self.timeout_s}s") from None
        else:
            res = await go()
        if res.get("@") == "err":
            raise RemoteSignerError(res.get("msg", "remote signer error"))
        return res

    async def ping(self) -> None:
        await self._round_trip({"@": "ping"})

    def get_pub_key(self):
        return self._pub_key

    async def sign_vote(self, chain_id: str, vote: Vote,
                        sign_extension: bool) -> None:
        res = await self._round_trip({
            "@": "sign_vote_req", "chain_id": chain_id,
            "vote": codec.to_dict(vote), "ext": sign_extension})
        signed: Vote = codec.from_dict(res["vote"])
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns
        vote.extension_signature = signed.extension_signature

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        res = await self._round_trip({
            "@": "sign_proposal_req", "chain_id": chain_id,
            "proposal": codec.to_dict(proposal)})
        signed: Proposal = codec.from_dict(res["proposal"])
        proposal.signature = signed.signature
        proposal.timestamp_ns = signed.timestamp_ns


class SignerListener(PrivValidator):
    """Node side of the reference topology: the node LISTENS on
    ``priv_validator_laddr`` and the remote signer dials in
    (``privval/signer_listener_endpoint.go``).

    Itself a PrivValidator: every operation runs against the currently
    connected signer, and a dropped connection triggers a re-accept of
    the signer's redial (the reference endpoint's WaitForConnection), so
    a signer restart does not halt the validator."""

    def __init__(self, accept_timeout: float = 30.0,
                 timeout_s: float = DEFAULT_ROUND_TRIP_TIMEOUT_S):
        self._server: asyncio.Server | None = None
        self._accepted: asyncio.Queue = asyncio.Queue()
        self._client: SignerClient | None = None
        self._accept_timeout = accept_timeout
        self._timeout_s = timeout_s
        self._lock = asyncio.Lock()

    async def listen(self, host: str = "127.0.0.1",
                     port: int = 0) -> tuple[str, int]:
        async def on_conn(reader, writer):
            await self._accepted.put((reader, writer))

        self._server = await asyncio.start_server(on_conn, host, port)
        addr = self._server.sockets[0].getsockname()
        return addr[0], addr[1]

    async def wait_for_signer(self, timeout: float | None = None
                              ) -> SignerClient:
        """Accept connections until one completes the pubkey handshake
        (a stray probe that connects without speaking is dropped)."""
        deadline = asyncio.get_event_loop().time() + (
            timeout if timeout is not None else self._accept_timeout)
        while True:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise RemoteSignerError(
                    "timed out waiting for the remote signer to connect")
            try:
                reader, writer = await asyncio.wait_for(
                    self._accepted.get(), remaining)
            except asyncio.TimeoutError:
                raise RemoteSignerError(
                    "timed out waiting for the remote signer to connect")
            try:
                self._client = await asyncio.wait_for(
                    SignerClient.from_streams(reader, writer,
                                              timeout_s=self._timeout_s),
                    min(5.0, max(0.1, remaining)))
                return self._client
            except Exception:  # a failed handshake closes; re-accept
                writer.close()

    async def _reconnect(self) -> SignerClient:
        old, self._client = self._client, None
        if old is not None:
            await old.close()
        return await self.wait_for_signer()

    async def _with_signer(self, op):
        """Run op against the live client; on a dropped connection OR a
        round-trip timeout (a wedged signer is indistinguishable from a
        dead link, and the abandoned request leaves the stream
        unframed), close + re-accept the signer's redial and retry
        once."""
        async with self._lock:
            if self._client is None:
                await self.wait_for_signer()
            try:
                return await op(self._client)
            except (asyncio.IncompleteReadError, ConnectionError,
                    SignerTimeoutError, OSError):
                # a dropped link or a wedged signer: close, re-accept
                # its redial, retry once
                await self._reconnect()
                return await op(self._client)

    # PrivValidator surface (delegates with reconnect)

    def get_pub_key(self):
        if self._client is None:
            raise RemoteSignerError("remote signer is not connected")
        return self._client.get_pub_key()

    async def sign_vote(self, chain_id: str, vote: Vote,
                        sign_extension: bool) -> None:
        await self._with_signer(
            lambda c: c.sign_vote(chain_id, vote, sign_extension))

    async def sign_proposal(self, chain_id: str, proposal) -> None:
        await self._with_signer(
            lambda c: c.sign_proposal(chain_id, proposal))

    async def ping(self) -> None:
        await self._with_signer(lambda c: c.ping())

    async def close(self) -> None:
        # close live + queued connections BEFORE wait_closed(): on 3.12
        # the server waits for every connection transport to finish, so
        # the reversed order deadlocks
        if self._client is not None:
            await self._client.close()
            self._client = None
        while not self._accepted.empty():
            _, writer = self._accepted.get_nowait()
            writer.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


async def serve_dialer(pv: PrivValidator, host: str, port: int,
                       max_retries: int = 0,
                       retry_interval: float = 1.0) -> None:
    """Signer side of the reference topology: dial the node's
    ``priv_validator_laddr`` and serve signing requests over the dialed
    connection until it closes (``privval/signer_dialer_endpoint.go`` +
    ``signer_server.go``).  Reconnects up to ``max_retries`` times
    (0 = forever), covering node restarts."""
    server = SignerServer(pv)
    attempts = 0
    while True:
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError:
            attempts += 1
            if max_retries and attempts >= max_retries:
                raise
            await asyncio.sleep(retry_interval)
            continue
        attempts = 0
        try:
            await server._serve(reader, writer)
        except Exception:  # close and redial
            writer.close()
        await asyncio.sleep(retry_interval)
