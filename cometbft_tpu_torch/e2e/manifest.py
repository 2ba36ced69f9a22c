"""e2e testnet manifest (counterpart of ``cometbft_tpu/e2e/manifest.py``;
reference: ``test/e2e/pkg/manifest.go``): a TOML description of a
network — node roles, validator powers, late starts,
perturbation schedule, load — that the runner turns into a live
multi-process testnet on localhost.

Example::

    initial_height = 1
    [validators]
    validator01 = 10
    validator02 = 10
    validator03 = 10

    [node.validator01]
    [node.validator02]
    perturb = ["kill:5", "restart:8"]
    [node.validator03]
    [node.full01]
    mode = "full"
    start_at = 4
    [node.light01]
    mode = "light"
    start_at = 6

    [load]
    rate = 20.0
    duration = 15.0
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field

MODES = ("validator", "full", "seed", "light")
PERTURBATIONS = ("kill", "restart", "pause", "resume")
DATABASES = ("logdb", "native", "memdb")
ABCI_PROTOCOLS = ("builtin", "socket", "grpc")


class ManifestError(Exception):
    pass


@dataclass
class NodeManifest:
    name: str = ""
    mode: str = "validator"            # manifest.go:158 ModeStr
    start_at: int = 0                  # join when the chain reaches this
    key_type: str = "ed25519"
    database: str = "logdb"            # storage.db_backend sweep axis
    abci_protocol: str = "builtin"     # builtin | socket | grpc (the
    #   runner spawns an external kvstore app process for socket and
    #   grpc, the latter serving with --grpc)
    # "action:height" entries, applied when the chain passes height
    perturb: list[str] = field(default_factory=list)

    def schedule(self) -> list[tuple[int, str]]:
        out = []
        for p in self.perturb:
            action, _, h = p.partition(":")
            if action not in PERTURBATIONS or not h.isdigit():
                raise ManifestError(
                    f"bad perturbation {p!r} on {self.name} "
                    f"(want action:height, action in {PERTURBATIONS})")
            out.append((int(h), action))
        return sorted(out)


@dataclass
class LoadManifest:
    rate: float = 10.0                 # tx/s
    duration: float = 10.0
    size: int = 64


@dataclass
class Manifest:
    initial_height: int = 1
    chain_id: str = "e2e-net"
    validators: dict = field(default_factory=dict)   # name -> power
    nodes: dict = field(default_factory=dict)        # name -> NodeManifest
    # height -> {node name -> power}: valset txs the runner submits when
    # the chain passes that height (manifest.go:34 ValidatorUpdatesMap;
    # power 0 removes the validator)
    validator_updates: dict = field(default_factory=dict)
    load: LoadManifest = field(default_factory=LoadManifest)
    # network-wide knobs
    emulated_latency_ms: float = 0.0
    fuzz: bool = False
    final_height: int = 10             # success bar: all nodes reach this

    def validate(self) -> None:
        if not self.nodes:
            raise ManifestError("manifest has no nodes")
        vals = [n for n in self.nodes.values() if n.mode == "validator"]
        if not vals:
            raise ManifestError("manifest has no validator nodes")
        for name in self.validators:
            if name not in self.nodes:
                raise ManifestError(f"validators entry {name!r} is not a "
                                    f"node")
        for n in self.nodes.values():
            if n.mode not in MODES:
                raise ManifestError(f"bad mode {n.mode!r} for {n.name}")
            if n.database not in DATABASES:
                raise ManifestError(f"bad database {n.database!r} for "
                                    f"{n.name} (want one of {DATABASES})")
            if n.abci_protocol not in ABCI_PROTOCOLS:
                raise ManifestError(
                    f"bad abci_protocol {n.abci_protocol!r} for {n.name} "
                    f"(want one of {ABCI_PROTOCOLS})")
            if n.database == "memdb" and any(
                    p.startswith(("kill", "restart")) for p in n.perturb):
                raise ManifestError(
                    f"{n.name}: memdb does not survive kill/restart "
                    f"perturbations")
            n.schedule()
        for h, updates in self.validator_updates.items():
            if h <= 0:
                raise ManifestError(f"validator_update height {h} "
                                    f"must be positive")
            for name, power in updates.items():
                node = self.nodes.get(name)
                if node is None or node.mode == "light":
                    raise ManifestError(f"validator_update target "
                                        f"{name!r} is not a backing node")
                if power < 0:
                    raise ManifestError(f"validator_update power for "
                                        f"{name!r} must be >= 0")
                if node.key_type != "ed25519":
                    # the kvstore valset tx carries ed25519 keys only
                    # (abci/kvstore.py:122)
                    raise ManifestError(
                        f"validator_update target {name!r} has key type "
                        f"{node.key_type!r}; only ed25519 is supported")

    def validator_powers(self) -> dict:
        """Explicit [validators] map, else all validator-mode nodes at
        power 100 (manifest.go:28 default)."""
        if self.validators:
            return dict(self.validators)
        return {name: 100 for name, n in self.nodes.items()
                if n.mode == "validator"}


def manifest_to_toml(m: Manifest) -> str:
    """Serialize a manifest back to the TOML the runner/CLI consume —
    the generator's output format."""
    def q(s: str) -> str:
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'

    lines = [f"chain_id = {q(m.chain_id)}",
             f"initial_height = {m.initial_height}",
             f"final_height = {m.final_height}"]
    if m.emulated_latency_ms:
        lines.append(f"emulated_latency_ms = {m.emulated_latency_ms}")
    if m.fuzz:
        lines.append("fuzz = true")
    if m.validators:
        lines.append("\n[validators]")
        for name, power in m.validators.items():
            lines.append(f"{name} = {power}")
    for name, n in m.nodes.items():
        lines.append(f"\n[node.{name}]")
        if n.mode != "validator":
            lines.append(f"mode = {q(n.mode)}")
        if n.start_at:
            lines.append(f"start_at = {n.start_at}")
        if n.key_type != "ed25519":
            lines.append(f"key_type = {q(n.key_type)}")
        if n.database != "logdb":
            lines.append(f"database = {q(n.database)}")
        if n.abci_protocol != "builtin":
            lines.append(f"abci_protocol = {q(n.abci_protocol)}")
        if n.perturb:
            lines.append("perturb = ["
                         + ", ".join(q(p) for p in n.perturb) + "]")
    for h, updates in sorted(m.validator_updates.items()):
        lines.append(f"\n[validator_update.{h}]")
        for name, power in updates.items():
            lines.append(f"{name} = {power}")
    lines.append("\n[load]")
    lines.append(f"rate = {m.load.rate}")
    lines.append(f"duration = {m.load.duration}")
    lines.append(f"size = {m.load.size}")
    return "\n".join(lines) + "\n"


def loads_toml(text: str) -> dict:
    """Manifest TOML text -> dict (``tomllib``; the JAX package's flat
    parser serves only Pythons before 3.11, which the port does not
    run on)."""
    return tomllib.loads(text)


def load_manifest(path: str) -> Manifest:
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    return manifest_from_dict(doc)


def manifest_from_dict(doc: dict) -> Manifest:
    m = Manifest()
    m.initial_height = int(doc.get("initial_height", 1))
    m.chain_id = doc.get("chain_id", "e2e-net")
    m.final_height = int(doc.get("final_height", 10))
    m.emulated_latency_ms = float(doc.get("emulated_latency_ms", 0.0))
    m.fuzz = bool(doc.get("fuzz", False))
    m.validators = {k: int(v) for k, v in doc.get("validators", {}).items()}
    for name, nd in doc.get("node", {}).items():
        nm = NodeManifest(name=name)
        nm.mode = nd.get("mode", "validator")
        nm.start_at = int(nd.get("start_at", 0))
        nm.key_type = nd.get("key_type", "ed25519")
        nm.database = nd.get("database", "logdb")
        nm.abci_protocol = nd.get("abci_protocol", "builtin")
        nm.perturb = list(nd.get("perturb", []))
        m.nodes[name] = nm
    for h, updates in doc.get("validator_update", {}).items():
        m.validator_updates[int(h)] = {k: int(v)
                                       for k, v in updates.items()}
    if "load" in doc:
        ld = doc["load"]
        m.load = LoadManifest(rate=float(ld.get("rate", 10.0)),
                              duration=float(ld.get("duration", 10.0)),
                              size=int(ld.get("size", 64)))
    m.validate()
    return m
