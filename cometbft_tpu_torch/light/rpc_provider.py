"""RPC-backed light-block provider (counterpart of ``cometbft_tpu/light/
rpc_provider.py``): headers, commits and validator sets from a full
node's JSON-RPC endpoint, port or JAX (reference: ``light/provider/http``,
the provider real light clients use).

Two robustness properties on top of the plain client:

- transient failures (connection drops, timeouts, a 503 from the
  serving node's admission gate) retry with bounded exponential backoff
  instead of failing the caller's whole bisection on one flaky fetch —
  a shed request is exactly the one the server ASKED us to retry;
- when the node runs the light-serving tier, one ``light_block`` RPC
  answers with header + commit + validator set in a single round trip;
  nodes without the route (pre-lightserve) degrade to the classic
  ``commit`` + paged ``validators`` fetch path automatically.
"""

from __future__ import annotations

import asyncio

from ..crypto.keys import pub_key_from_type_bytes
from ..libs import log as _tmlog
from ..rpc.client import HTTPClient
from ..rpc.core import RPCError
from ..rpc.json import from_jsonable, jsonable
from ..types.validator_set import Validator, ValidatorSet
from .provider import ErrLightBlockNotFound, Provider
from .types import LightBlock

__all__ = ["RPCProvider"]


def _transient(e: Exception) -> bool:
    """Worth retrying?  Network-layer failures and the serving node's
    overload shed (HTTP 503 / JSON-RPC -32000 "overloaded") are
    transient; a definitive RPC answer (no such height, bad params) is
    not."""
    if isinstance(e, (ConnectionError, asyncio.TimeoutError, OSError)):
        return True
    if isinstance(e, RPCError) and e.code == -32000:
        return True
    return False


class RPCProvider(Provider):
    def __init__(self, host: str, port: int, name: str | None = None,
                 *, tls: bool = False, retries: int = 2,
                 backoff_s: float = 0.25):
        """``tls=True`` reaches an HTTPS-configured node (self-signed
        accepted: the light client's trust comes from header hashes and
        the trusted anchor, not from the TLS channel).  ``retries`` bounds
        how many times one call is re-attempted on a transient failure
        (0 disables), each wait doubling from ``backoff_s``."""
        self.client = HTTPClient(host, port, tls=tls, tls_verify=False)
        self.name = name or f"rpc:{host}:{port}"
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        # None = unknown, probed on first light_block; False once the
        # node answered "method not found" (pre-lightserve node)
        self._has_light_block: bool | None = None

    def id(self) -> str:
        return self.name

    async def _call(self, method: str, **params):
        """One RPC with bounded-backoff retry on transient failures."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return await self.client.call(method, **params)
            except Exception as e:
                if attempt >= self.retries or not _transient(e):
                    raise
                _tmlog.logger("light").warn(
                    "transient provider error; retrying",
                    provider=self.name, method=method,
                    attempt=attempt + 1, err=str(e))
                if delay > 0:
                    await asyncio.sleep(delay)
                delay *= 2

    async def report_evidence(self, evidence) -> None:
        """Deliver attack evidence to the node behind this provider via a
        ``/broadcast_evidence`` round-trip (light/provider/http
        ReportEvidence) — the detector sends each side's incriminating
        evidence to the honest party, and the base-class no-op silently
        dropped it for RPC-backed witnesses.  Submission is best-effort:
        a dead or rejecting node logs a warning (the divergence itself
        still raises at the caller), it must not mask the fork."""
        try:
            await self._call("broadcast_evidence",
                             evidence=jsonable(evidence))
        except Exception as e:
            _tmlog.logger("light").warn(
                "evidence report failed; the peer never received it",
                provider=self.name, err=str(e))

    async def light_block(self, height: int) -> LightBlock:
        if self._has_light_block is not False:
            try:
                return await self._light_block_served(height)
            except RPCError as e:
                if e.code == -32601:
                    # route absent or tier disabled: remember and fall
                    # back to the classic three-fetch path
                    self._has_light_block = False
                else:
                    raise ErrLightBlockNotFound(f"{self.name}: {e}") from e
            except OSError as e:
                raise ErrLightBlockNotFound(
                    f"{self.name}: unreachable: {e}") from e
        return await self._light_block_classic(height)

    async def _light_block_served(self, height: int) -> LightBlock:
        """Single-round-trip fetch through the serving tier."""
        res = await self._call("light_block", height=height or None)
        self._has_light_block = True
        lb = res.get("light_block") or {}
        header = from_jsonable(lb.get("header"))
        commit = from_jsonable(lb.get("commit"))
        vals = from_jsonable(lb.get("validators"))
        if header is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(
                f"{self.name}: malformed light block at {height}")
        return LightBlock(header=header, commit=commit, validators=vals)

    async def _light_block_classic(self, height: int) -> LightBlock:
        try:
            cm = await self._call("commit", height=height or None)
            if cm.get("header") is None or cm.get("commit") is None:
                raise ErrLightBlockNotFound(
                    f"{self.name}: no commit at {height}")
            header = from_jsonable(cm["header"])
            commit = from_jsonable(cm["commit"])
            vals = await self._validators(commit.height)
        except RPCError as e:
            raise ErrLightBlockNotFound(f"{self.name}: {e}") from e
        except OSError as e:
            raise ErrLightBlockNotFound(
                f"{self.name}: unreachable: {e}") from e
        return LightBlock(header=header, commit=commit, validators=vals)

    async def _validators(self, height: int) -> ValidatorSet:
        vals: list[Validator] = []
        page = 1
        while True:
            res = await self._call("validators", height=height,
                                   page=page, per_page=100)
            for v in res["validators"]:
                vals.append(Validator(
                    pub_key_from_type_bytes(v["pub_key_type"],
                                            bytes.fromhex(v["pub_key"])),
                    v["voting_power"], v["proposer_priority"]))
            if len(vals) >= res["total"] or not res["validators"]:
                return ValidatorSet(vals)
            page += 1
