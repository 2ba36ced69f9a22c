"""FilePV: file-backed validator key with persisted last-sign-state and
double-sign protection (counterpart of ``cometbft_tpu/privval/file.py``;
reference: ``privval/file.go:75-142`` FilePVKey / FilePVLastSignState,
``:164`` FilePV, ``:332`` signVote).  The key and state files are the
JAX package's: each package loads the other's.  Ed25519, secp256k1 and
BLS12-381 keys.

Safety argument (file.go:100 CheckHRS): the signer never signs two
different messages for the same (height, round, step).  The last sign
state — including the produced signature and the exact sign bytes — is
fsync'd to disk *before* the signature is released, so a crash between
signing and broadcasting cannot lead to equivocation after restart.  A
re-request for the identical HRS returns the stored signature; one that
differs only in timestamp returns the stored signature with the stored
timestamp; anything else is refused."""

from __future__ import annotations

import errno
import json
import os

from ..crypto.keys import gen_priv_key, priv_key_from_type_bytes
from ..crypto import bls12381 as _bls
from ..libs import failures
from ..types import canonical
from ..types.canonical import canonical_vote_sign_bytes
from ..types.priv_validator import PrivValidator
from ..types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Proposal, Vote

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {PREVOTE_TYPE: STEP_PREVOTE, PRECOMMIT_TYPE: STEP_PRECOMMIT}


class DoubleSignError(Exception):
    """Refusal to sign: would conflict with the last signed state."""


class SignStateError(Exception):
    """The last-sign-state file is unreadable, incomplete, or its handle
    went dead after an IO failure.  NEVER auto-reset or delete the state
    file to clear this: the last-sign state is the only thing standing
    between a restarted validator and equivocation — resetting sign
    state is how validators double-sign.  Restore the file from a
    backup, or keep the validator offline until you can prove what this
    key last signed."""


class FilePV(PrivValidator):
    def __init__(self, priv_key, key_path: str,
                 state_path: str):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        # last sign state (file.go FilePVLastSignState)
        self.height = 0
        self.round = 0
        self.step = 0
        self.signature = b""
        self.sign_bytes = b""
        self.ext_signature = b""
        # fsyncgate for the sign-state file: after one failed persist the
        # on-disk state may not reflect memory — every further sign
        # attempt must refuse (recovery is an operator restart, which
        # re-reads the file that DID land)
        self._io_failed: Exception | None = None

    # ------------------------------------------------------------- file io

    @classmethod
    def generate(cls, key_path: str, state_path: str,
                 key_type: str = "ed25519") -> "FilePV":
        pv = cls(gen_priv_key(key_type), key_path, state_path)
        pv.save_key()
        pv._save_state()
        return pv

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            kd = json.load(f)
        pv = cls(priv_key_from_type_bytes(kd.get("type", "ed25519"),
                                          bytes.fromhex(kd["priv_key"])),
                 key_path, state_path)
        if os.path.exists(state_path):
            # a corrupt/truncated state file must be a TYPED refusal with
            # the never-auto-reset warning, not a raw JSONDecodeError an
            # operator might "fix" with unsafe-reset-all
            try:
                with open(state_path) as f:
                    sd = json.load(f)
                pv.height = int(sd["height"])
                pv.round = int(sd["round"])
                pv.step = int(sd["step"])
                pv.signature = bytes.fromhex(sd.get("signature", ""))
                pv.sign_bytes = bytes.fromhex(sd.get("signbytes", ""))
                pv.ext_signature = bytes.fromhex(sd.get("ext_signature", ""))
            except (OSError, ValueError, KeyError, TypeError) as e:
                raise SignStateError(
                    f"priv_validator state file {state_path!r} is corrupt, "
                    f"truncated, or unreadable ({e!r}).  Do NOT reset or "
                    "delete it — resetting sign state is how validators "
                    "double-sign.  Restore the file (or its permissions) "
                    "from a backup, or keep this validator offline until "
                    "you can prove what this key last signed.") from e
        return pv

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str,
                         key_type: str = "ed25519") -> "FilePV":
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        return cls.generate(key_path, state_path, key_type)

    def save_key(self) -> None:
        pub = self.priv_key.pub_key()
        doc = {
            "address": pub.address().hex(),
            "type": pub.type(),
            "pub_key": pub.bytes().hex(),
            "priv_key": self.priv_key.bytes().hex(),
        }
        if pub.type() == "bls12_381":
            # proof of possession: the rogue-key defense the aggregate
            # fast path rests on.  Generated once at keygen, persisted
            # beside the key, published with the pubkey (genesis /
            # validator updates) and checked at admission.
            doc["pop"] = _bls.pop_prove(self.priv_key.bytes()).hex()
        _atomic_write_json(self.key_path, doc)

    def pop(self) -> bytes:
        """The key's proof of possession (BLS only; b"" otherwise) —
        read back from the key file when present, derived for legacy
        key files that predate the field.  An unreadable or corrupt key
        file raises: silently re-deriving would mask the same IO fault
        that load() refuses to paper over."""
        if self.priv_key.type() != "bls12_381":
            return b""
        stored = ""
        if os.path.exists(self.key_path):
            with open(self.key_path) as f:
                stored = json.load(f).get("pop", "")
        if stored:
            return bytes.fromhex(stored)
        return _bls.pop_prove(self.priv_key.bytes())

    def _check_alive(self) -> None:
        if self._io_failed is not None:
            raise SignStateError(
                "priv_validator sign state failed to persist earlier; "
                "refusing every further signature until restart (the "
                "on-disk state may not reflect memory)") \
                from self._io_failed

    def _save_state(self) -> None:
        """fsync'd BEFORE the signature leaves this process (file.go:332
        'signature is saved to disk before it is returned').  An IO
        failure here must NOT release the signature — the caller sees
        the raised OSError before any signature is assigned to the vote
        or proposal, and this handle goes dead (fsyncgate)."""
        self._check_alive()
        try:
            fired = failures.fire("privval.state.fsync.eio")
            if fired is not None:
                raise OSError(
                    errno.EIO, "chaos: injected privval state fsync EIO")
            _atomic_write_json(self.state_path, {
                "height": self.height,
                "round": self.round,
                "step": self.step,
                "signature": self.signature.hex(),
                "signbytes": self.sign_bytes.hex(),
                "ext_signature": self.ext_signature.hex(),
            })
        except OSError as e:
            self._io_failed = e
            raise

    # ------------------------------------------------------------- signing

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def _check_hrs(self, height: int, round_: int, step: int) -> bool:
        """file.go:100 CheckHRS: monotonic, returns True if same HRS."""
        if self.height > height:
            raise DoubleSignError(f"height regression {self.height}->{height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression {self.round}->{round_} @ {height}")
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression {self.step}->{step} "
                        f"@ {height}/{round_}")
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign bytes for same HRS")
                    return True
        return False

    async def sign_vote(self, chain_id: str, vote: Vote,
                        sign_extension: bool) -> None:
        self._check_alive()
        step = _VOTE_STEP[vote.type]
        same_hrs = self._check_hrs(vote.height, vote.round, step)
        # sign bytes follow the key type: a BLS validator signs the
        # zero-timestamp aggregation domain (types/vote.py
        # sign_bytes_for), so its precommits can fold into the commit's
        # aggregate.  The sign-state discipline is unchanged — the
        # stored sign_bytes are whatever was actually signed.
        sb = vote.sign_bytes_for(chain_id, self.priv_key.type())
        if same_hrs:
            if sb == self.sign_bytes:
                vote.signature = self.signature
            else:
                ts = _vote_ts_from_state(self, chain_id, vote)
                if ts is None:
                    raise DoubleSignError(
                        "conflicting vote data for same height/round/step")
                # identical modulo timestamp: reuse stored sig + timestamp
                vote.timestamp_ns = ts
                vote.signature = self.signature
            if sign_extension:
                vote.extension_signature = self.ext_signature
            return
        sig = self.priv_key.sign(sb)
        ext_sig = b""
        if sign_extension:
            ext_sig = self.priv_key.sign(vote.extension_sign_bytes(chain_id))
        self.height, self.round, self.step = vote.height, vote.round, step
        self.signature, self.sign_bytes = sig, sb
        self.ext_signature = ext_sig
        self._save_state()
        vote.signature = sig
        if sign_extension:
            vote.extension_signature = ext_sig

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        self._check_alive()
        same_hrs = self._check_hrs(proposal.height, proposal.round,
                                   STEP_PROPOSE)
        sb = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sb == self.sign_bytes:
                proposal.signature = self.signature
                return
            raise DoubleSignError(
                "conflicting proposal data for same height/round")
        sig = self.priv_key.sign(sb)
        self.height, self.round, self.step = (proposal.height,
                                              proposal.round, STEP_PROPOSE)
        self.signature, self.sign_bytes = sig, sb
        self.ext_signature = b""
        self._save_state()
        proposal.signature = sig


def _vote_ts_from_state(pv: FilePV, chain_id: str, vote: Vote) -> int | None:
    """If the new vote differs from the stored one ONLY by timestamp,
    return the stored timestamp (file.go checkVotesOnlyDifferByTimestamp).
    Probes by re-encoding the new vote with candidate timestamps."""
    # cheap exact check: re-encode with every plausible stored ts is not
    # possible (ts not stored separately), so compare canonical encodings
    # with the new vote's ts substituted out
    for probe_ts in _extract_ts_candidates(pv.sign_bytes):
        cand = canonical_vote_sign_bytes(
            chain_id, vote.type, vote.height, vote.round, vote.block_id,
            probe_ts)
        if cand == pv.sign_bytes:
            return probe_ts
    return None


def _extract_ts_candidates(sign_bytes: bytes):
    """Best-effort: decode the timestamp field from stored canonical vote
    bytes.  The canonical encoding is deterministic, so substituting the
    decoded ts must reproduce ``sign_bytes`` exactly for a match."""
    try:
        yield canonical.decode_timestamp_from_vote(sign_bytes)
    except Exception:   # no candidate: no timestamp-only match
        return


def _atomic_write_json(path: str, obj: dict) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
