"""GenesisDoc (reference: ``types/genesis.go``): the chain's bootstrap
document.

Counterpart of ``cometbft_tpu/types/genesis.py``.  The JAX package also
refuses BLS genesis keys when its BLS backend is its non-standard
pure-Python suite; the port's BLS library (``crypto/bls12381.py``)
speaks the standard suite, so that check has nothing to refuse here.
The proof-of-possession check on every BLS key stays.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field

from ..crypto.keys import pub_key_from_type_bytes
from .params import ConsensusParams, default_consensus_params
from .validator_set import Validator, ValidatorSet

__all__ = ["MAX_CHAIN_ID_LEN", "GenesisError", "GenesisValidator",
           "GenesisDoc"]

MAX_CHAIN_ID_LEN = 50


class GenesisError(Exception):
    pass


@dataclass
class GenesisValidator:
    pub_key: object
    power: int
    name: str = ""
    # proof of possession, required for bls12_381 keys (the rogue-key
    # defence of aggregate commits)
    pop: bytes = b""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(
        default_factory=default_consensus_params)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> None:
        """types/genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise GenesisError("genesis doc must include chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise GenesisError("chain_id too long")
        if self.initial_height < 1:
            raise GenesisError("initial_height must be >= 1")
        err = self.consensus_params.validate()
        if err:
            raise GenesisError(err)
        for v in self.validators:
            if v.power < 0:
                raise GenesisError("validator power cannot be negative")
        for v in self.validators:
            if v.pub_key.type() != "bls12_381":
                continue
            from ..crypto import bls12381 as _bls

            if not v.pop:
                raise GenesisError(
                    f"genesis validator {v.name or v.pub_key!r} has a "
                    "bls12_381 key but no proof of possession ('pop')")
            if not _bls.pop_verify(v.pub_key.bytes(), v.pop):
                raise GenesisError(
                    f"genesis validator {v.name or v.pub_key!r}: "
                    "bls12_381 proof of possession failed to verify")

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([Validator(v.pub_key, v.power)
                             for v in self.validators])

    # ------------------------------------------------------------- json io

    def to_json(self) -> str:
        cp = self.consensus_params
        return json.dumps({
            "chain_id": self.chain_id,
            "genesis_time_ns": self.genesis_time_ns,
            "initial_height": self.initial_height,
            "validators": [{
                "pub_key": {"type": v.pub_key.type(),
                            "value": base64.b64encode(
                                v.pub_key.bytes()).decode()},
                "power": v.power,
                "name": v.name,
                **({"pop": v.pop.hex()} if v.pop else {}),
            } for v in self.validators],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state.decode("utf-8", "replace"),
            "consensus_params": {
                "block": {"max_bytes": cp.block.max_bytes,
                          "max_gas": cp.block.max_gas},
                "evidence": {
                    "max_age_num_blocks": cp.evidence.max_age_num_blocks,
                    "max_age_duration_ns": cp.evidence.max_age_duration_ns,
                    "max_bytes": cp.evidence.max_bytes,
                },
                "validator": {
                    "pub_key_types": cp.validator.pub_key_types,
                },
                "version": {"app": cp.version.app},
                "feature": {
                    "vote_extensions_enable_height":
                        cp.feature.vote_extensions_enable_height,
                    "pbts_enable_height": cp.feature.pbts_enable_height,
                },
                "synchrony": {
                    "precision_ns": cp.synchrony.precision_ns,
                    "message_delay_ns": cp.synchrony.message_delay_ns,
                },
            },
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "GenesisDoc":
        d = json.loads(s)
        params = default_consensus_params()
        cp = d.get("consensus_params", {})

        def load_into(obj, section: str):
            for k, v in cp.get(section, {}).items():
                if hasattr(obj, k):
                    setattr(obj, k, v)

        for section in ("block", "evidence", "validator", "version",
                        "feature", "synchrony"):
            load_into(getattr(params, section), section)
        vals = []
        for v in d.get("validators", []):
            try:
                key = pub_key_from_type_bytes(
                    v["pub_key"]["type"],
                    base64.b64decode(v["pub_key"]["value"]))
            except ValueError as e:
                raise GenesisError(f"bad genesis validator key: {e}") from e
            try:
                pop = bytes.fromhex(v.get("pop", ""))
            except ValueError as e:
                raise GenesisError(f"bad genesis validator pop: {e}") from e
            vals.append(GenesisValidator(key, int(v["power"]),
                                         v.get("name", ""), pop))
        doc = cls(chain_id=d["chain_id"],
                  genesis_time_ns=d.get("genesis_time_ns", 0),
                  initial_height=d.get("initial_height", 1),
                  consensus_params=params, validators=vals,
                  app_hash=bytes.fromhex(d.get("app_hash", "")),
                  app_state=d.get("app_state", "{}").encode())
        doc.validate_and_complete()
        return doc

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
