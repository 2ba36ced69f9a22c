"""e2e testnet runner (counterpart of ``cometbft_tpu/e2e/runner.py``;
reference: ``test/e2e/runner``): turn a Manifest into a live
multi-OS-process testnet on localhost — generate wired homes, spawn node
processes through the command line (``python -m cometbft_tpu_torch``),
start late joiners when the chain reaches their height, apply the
perturbation schedule, drive load, and check the end-state invariants
(progress, agreement, light-client verification).

The reference orchestrates docker containers; one machine with OS
processes exercises the same protocol surface (real TCP, real processes,
real kill/pause signals).

Where the JAX runner differs: every process it starts checks signatures
on ``device`` (``None``: the card; ``"cpu"`` is passed as ``--device cpu``
to each), where the JAX runner pins its nodes to the host; a node
process that exits without the schedule killing it fails
the run; a node's next perturbation waits until the chain has passed the
height its previous one fired at; each new height the watched node
reports is logged (``[e2e] height H``); and the load's random bytes
come from ``rng``."""

from __future__ import annotations

import asyncio
import os
import random
import signal
import subprocess
import sys
import time

from .manifest import Manifest

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


class RunnerError(Exception):
    pass


def free_port_base(n: int, start: int | None = None) -> int:
    """A base port whose next ``n`` ports are free now: the first from
    ``start`` in steps of ``n``, or, with no ``start``, one at random in
    20000-30000 (processes looking at once then rarely meet)."""
    import socket

    bases = (range(start, 32768 - n, n) if start is not None else
             (random.randrange(20000, 30000) for _ in range(200)))
    for base in bases:
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RunnerError(f"no {n} free ports")


class Runner:
    def __init__(self, manifest: Manifest, base_dir: str,
                 base_port: int = 26656, fast_timeouts: bool = True,
                 log=print, device: str | None = None,
                 rng: random.Random | None = None):
        self.m = manifest
        self.device = device
        self.rng = rng if rng is not None else random.Random()
        self.base_dir = base_dir
        self.base_port = base_port
        self.fast_timeouts = fast_timeouts
        self.log = log
        self.procs: dict[str, subprocess.Popen] = {}
        self.app_procs: dict[str, subprocess.Popen] = {}
        self.paused: set[str] = set()
        self.killed: set[str] = set()     # killed and not restarted
        self.node_ids: dict[str, str] = {}   # filled by setup()
        # stable order: validators first so port 0 is a validator RPC
        self.names = sorted(
            self.m.nodes,
            key=lambda n: (self.m.nodes[n].mode != "validator", n))
        self.ports = {name: base_port + 3 * i
                      for i, name in enumerate(self.names)}

    def app_port(self, name: str) -> int:
        """Port of the external ABCI app process (socket/grpc nodes)."""
        return self.ports[name] + 2

    # ---------------------------------------------------------- setup

    def home(self, name: str) -> str:
        return os.path.join(self.base_dir, name)

    def rpc_port(self, name: str) -> int:
        return self.ports[name] + 1

    def setup(self) -> None:
        """testnet generation per manifest roles (runner/setup.go).

        The working dir is WIPED first (runner/cleanup.go runs before
        every setup): a previous run's chain data under the same --dir
        otherwise bleeds into this run — a different manifest's genesis
        against stale blockstores produced stuck-at-0 nodes and replay
        crashes before this existed.  Safety: only a dir this runner
        CREATED (marker file present) or an empty dir is ever removed —
        `--dir ~/work` must not recursively delete user data — and a
        failed wipe raises instead of silently running on stale state."""
        import shutil as _shutil

        marker = os.path.join(self.base_dir, ".e2e-testnet")
        if os.path.isdir(self.base_dir):
            if not (os.path.exists(marker)
                    or not os.listdir(self.base_dir)):
                raise RunnerError(
                    f"refusing to wipe {self.base_dir!r}: it was not "
                    "created by this runner (no .e2e-testnet marker) "
                    "and is not empty — pass a fresh --dir")
            _shutil.rmtree(self.base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        with open(marker, "w") as f:
            f.write("generated by cometbft_tpu_torch e2e; safe to delete\n")
        from .gen import HomeSpec, generate_homes

        powers = self.m.validator_powers()
        backing = [n for n in self.names
                   if self.m.nodes[n].mode != "light"]
        seeds = [n for n in backing if self.m.nodes[n].mode == "seed"]
        specs = [HomeSpec(name=n, p2p_port=self.ports[n],
                          rpc_port=self.rpc_port(n),
                          power=powers.get(n),
                          key_type=self.m.nodes[n].key_type)
                 for n in backing]

        def peers(spec) -> str:
            # with seeds in the topology, non-seed nodes discover the
            # network through them via PEX (manifest.go seed semantics);
            # otherwise everyone wires to everyone
            if seeds and spec.name not in seeds:
                return ""
            return ",".join(f"tcp://127.0.0.1:{self.ports[o]}"
                            for o in backing if o != spec.name)

        def tweak(spec, cfg) -> None:
            cfg.p2p.emulated_latency_ms = self.m.emulated_latency_ms
            node = self.m.nodes[spec.name]
            cfg.storage.db_backend = node.database
            cfg.p2p.seed_mode = spec.name in seeds
            if node.abci_protocol != "builtin":
                cfg.base.abci = node.abci_protocol
                cfg.base.proxy_app = f"127.0.0.1:{self.app_port(spec.name)}"
            if seeds and spec.name not in seeds:
                cfg.p2p.seeds = ",".join(
                    f"tcp://127.0.0.1:{self.ports[s]}" for s in seeds)
            if self.m.fuzz:
                cfg.p2p.test_fuzz = True
                cfg.p2p.fuzz_start_after_s = 5.0
            if self.fast_timeouts:
                cfg.consensus.timeout_propose = 300_000_000
                cfg.consensus.timeout_prevote = 150_000_000
                cfg.consensus.timeout_precommit = 150_000_000
                cfg.consensus.timeout_commit = 100_000_000

        generate_homes(self.base_dir, specs, self.m.chain_id,
                       initial_height=self.m.initial_height,
                       persistent_peers=peers, tweak=tweak)

        # expected node identity per name: a STALE node from a previous
        # (killed) run squatting this run's ports answers RPC happily —
        # same chain id, same moniker names — and poisons the run with
        # another chain's blocks.  Observed as an "app hash mismatch
        # after replay" flake before status polls verified node ids.
        from ..p2p import NodeKey

        self.node_ids = {}
        for spec in specs:
            path = os.path.join(self.base_dir, spec.name, "config",
                                "node_key.json")
            try:
                self.node_ids[spec.name] = NodeKey.load_or_gen(path).id
            except Exception:
                pass

    # ---------------------------------------------------------- process

    def _check_identity(self, name: str, st: dict) -> None:
        """Raise when a status response came from a node OTHER than the
        one this runner generated for ``name`` — a foreign process
        (usually a stale node from a killed previous run) squatting the
        port, which would poison the run with another chain's data."""
        want = self.node_ids.get(name)
        info = st.get("node_info", {}) if isinstance(st, dict) else {}
        got = info.get("id")
        if want and got and got != want:
            raise RunnerError(
                f"{name}: rpc port {self.rpc_port(name)} is served by a "
                f"FOREIGN node (id {got!r}, moniker "
                f"{info.get('moniker')!r}; expected id {want!r}) — a "
                f"stale process from a previous run is squatting the "
                f"port; kill it or use a different base port")

    def _cli(self, *args: str) -> list[str]:
        """``python -m cometbft_tpu_torch`` with the runner's device."""
        dev = () if self.device is None else ("--device", str(self.device))
        return [sys.executable, "-m", "cometbft_tpu_torch", *dev, *args]

    def _spawn(self, name: str) -> None:
        node = self.m.nodes[name]
        env = dict(os.environ, PYTHONPATH=_REPO)
        if node.abci_protocol != "builtin" and name not in self.app_procs:
            # out-of-process app: one kvstore server per node, living
            # across node kill/restart perturbations (the external-app
            # topology the reference's generator sweeps)
            app_cmd = self._cli("abci", "kvstore", "--port",
                                str(self.app_port(name)))
            if node.abci_protocol == "grpc":
                app_cmd.append("--grpc")
            app_log = open(os.path.join(self.base_dir,
                                        f"{name}.app.log"), "ab")
            self.log(f"[e2e] starting {name} app ({node.abci_protocol})")
            self.app_procs[name] = subprocess.Popen(
                app_cmd, stdout=app_log, stderr=subprocess.STDOUT,
                env=env, cwd=_REPO)
            app_log.close()
            self._wait_for_port(self.app_port(name), 20.0)
        if node.mode == "light":
            cmd = self._light_cmd(name)
        else:
            cmd = self._cli("--home", self.home(name), "start")
        self.log(f"[e2e] starting {name} ({node.mode})")
        log_path = os.path.join(self.base_dir, f"{name}.log")
        log_f = open(log_path, "ab")
        self.procs[name] = subprocess.Popen(
            cmd, stdout=log_f, stderr=subprocess.STDOUT,
            env=env, cwd=_REPO)
        log_f.close()          # the child keeps its own fd

    def _wait_for_port(self, port: int, timeout_s: float) -> None:
        """Block until the app server accepts connections: the node
        process has no connect-retry, so losing the interpreter-startup
        race would crash it at boot with ConnectionRefused."""
        import socket

        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=1.0):
                    return
            except OSError:
                time.sleep(0.1)
        raise RunnerError(f"app server on port {port} never came up")

    def _light_cmd(self, name: str) -> list[str]:
        primary = self._primary_name()
        anchor = self._trust_anchor
        return self._cli("light",
                         "--primary", f"127.0.0.1:{self.rpc_port(primary)}",
                         "--chain-id", self.m.chain_id,
                         "--trust-height", str(anchor[0]),
                         "--trust-hash", anchor[1],
                         "--port", str(self.rpc_port(name)))

    def _primary_name(self) -> str:
        """The node the runner watches (and light clients trust).  Must
        be one that STAYS UP: watching a node the schedule pauses or
        kills turns a healthy mid-perturbation network into a spurious
        rpc-timeout failure (observed with a generated 2-validator
        manifest that SIGSTOPped the first validator)."""
        candidates = [n for n in self.names
                      if self.m.nodes[n].mode in ("validator", "full")
                      and self.m.nodes[n].start_at == 0]

        def badness(n: str) -> int:
            # actions in EXECUTION order (schedule() sorts by height;
            # the raw manifest list may not be sorted)
            actions = [a for _, a in self.m.nodes[n].schedule()]
            if not actions:
                return 0               # never touched: ideal
            if actions[-1] in ("restart", "resume"):
                return 1               # perturbed but ends recovered
            return 2                   # ends killed/paused: last resort
        # Known limit: when EVERY candidate is perturbed, a watch node
        # that goes down mid-run still fails the run before its own
        # recovery action can fire (recovery is dispatched from the
        # watch loop itself); ranking just picks the least-doomed one.
        if candidates:
            return min(candidates, key=badness)
        raise RunnerError("no primary for light node")

    # ------------------------------------------------------------- run

    async def run(self, deadline_s: float = 240.0) -> dict:
        from ..rpc import HTTPClient, RPCError

        async def call(port, method, timeout=30.0, **kw):
            cli = HTTPClient("127.0.0.1", port)
            end = time.monotonic() + timeout
            while True:
                try:
                    # per-attempt bound: a SIGSTOPped node accepts the TCP
                    # connection but never answers, and the retry-loop
                    # timeout only runs between attempts
                    return await asyncio.wait_for(cli.call(method, **kw),
                                                  10.0)
                except (OSError, RPCError, asyncio.TimeoutError):
                    if time.monotonic() > end:
                        raise
                    self._check_alive()
                    await asyncio.sleep(0.3)

        pending_start = {n for n in self.names
                         if self.m.nodes[n].start_at > 0
                         or self.m.nodes[n].mode == "light"}
        for name in self.names:
            if name not in pending_start:
                self._spawn(name)

        schedule = []          # (height, action, node) not yet applied
        for name in self.names:
            for h, action in self.m.nodes[name].schedule():
                schedule.append((h, action, name))
        schedule.sort()
        valset_updates = sorted(self.m.validator_updates.items())

        watch_port = self.rpc_port(self._primary_name())
        self._check_identity(self._primary_name(),
                             await call(watch_port, "status", timeout=60.0))
        load_task = asyncio.create_task(self._drive_load(watch_port))
        self._trust_anchor = None
        last_perturb_t = time.monotonic()
        fired_at: dict[str, int] = {}     # node -> height of its last action
        seen_h = -1
        deadline = time.monotonic() + deadline_s
        try:
            while True:
                self._check_alive()
                st = await call(watch_port, "status")
                h = st["sync_info"]["latest_block_height"]
                if h != seen_h:
                    self.log(f"[e2e] height {h}")
                    seen_h = h

                anchor_h = self.m.initial_height + 1
                if (self._trust_anchor is None and h >= anchor_h
                        and any(self.m.nodes[n].mode == "light"
                                for n in self.names)):
                    blk = await call(watch_port, "block", height=anchor_h)
                    self._trust_anchor = (anchor_h,
                                          blk["block_id"]["hash"]["~b"])

                for name in sorted(pending_start):
                    node = self.m.nodes[name]
                    needs_anchor = node.mode == "light"
                    if h >= node.start_at and (
                            not needs_anchor or self._trust_anchor):
                        pending_start.discard(name)
                        self._spawn(name)

                # apply due perturbations anywhere in the schedule (not
                # just the head): recovery actions (restart/resume) also
                # fire after a stall grace, because a kill/pause may have
                # cost the chain its quorum and made their trigger height
                # unreachable — per-node order is still preserved.  A
                # node's next action waits until the chain has passed the
                # height its previous one fired at: a chain faster than
                # the poll would otherwise see pause:8 and resume:9 both
                # due in one poll, and the pause would hold for no time
                fired = True
                while fired:
                    fired = False
                    for i, (sched_h, action, name) in enumerate(schedule):
                        earlier_same_node = any(
                            n2 == name for _, _, n2 in schedule[:i])
                        due = (sched_h <= h
                               and h > fired_at.get(name, -1)) or (
                            action in ("restart", "resume")
                            and not earlier_same_node
                            and time.monotonic() - last_perturb_t > 10.0)
                        if due:
                            schedule.pop(i)
                            self._perturb(name, action)
                            fired_at[name] = h
                            last_perturb_t = time.monotonic()
                            fired = True
                            break

                while valset_updates and valset_updates[0][0] <= h:
                    _, updates = valset_updates.pop(0)
                    for vname, power in updates.items():
                        await self._submit_valset_tx(call, watch_port,
                                                     vname, power)

                if (h >= self.m.final_height and not pending_start
                        and not schedule and not valset_updates):
                    break
                if time.monotonic() > deadline:
                    raise RunnerError(
                        f"deadline: h={h}, pending={pending_start}, "
                        f"schedule={schedule}")
                await asyncio.sleep(0.5)
        finally:
            load_task.cancel()

        return await self._check_invariants(call)

    def _perturb(self, name: str, action: str) -> None:
        self.log(f"[e2e] perturb {action} {name}")
        proc = self.procs.get(name)
        if action == "kill" and proc is not None:
            if name in self.paused:          # SIGKILL works on stopped too
                self.paused.discard(name)
            proc.kill()
            proc.wait()
            self.killed.add(name)
        elif action == "restart":
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            self.paused.discard(name)        # a fresh process is running
            self.killed.discard(name)
            self._spawn(name)
        elif action == "pause" and proc is not None:
            proc.send_signal(signal.SIGSTOP)
            self.paused.add(name)
        elif action == "resume" and proc is not None:
            proc.send_signal(signal.SIGCONT)
            self.paused.discard(name)

    async def _drive_load(self, port: int) -> None:
        from ..rpc import HTTPClient, RPCError

        cli = HTTPClient("127.0.0.1", port)
        ld = self.m.load
        if ld.rate <= 0 or ld.duration <= 0:
            return                     # load disabled
        end = time.monotonic() + ld.duration
        i = 0
        while time.monotonic() < end:
            tx = (b"e2e%06d=" % i) + self.rng.randbytes(
                max(1, ld.size // 2)).hex().encode()[:ld.size]
            try:
                await cli.call("broadcast_tx_async", tx=tx.hex())
            except Exception:
                pass
            i += 1
            await asyncio.sleep(1.0 / ld.rate)

    def _check_alive(self) -> None:
        """Raise when a process exited that the schedule did not kill: a
        node that could not reach its device, or crashed."""
        for name, proc in self.procs.items():
            rc = proc.poll()
            if rc is not None and name not in self.killed:
                raise RunnerError(f"{name} exited with code {rc}; last log "
                                  f"lines:\n{self._log_tail(name)}")

    # ------------------------------------------------------ invariants

    async def _check_invariants(self, call) -> dict:
        """runner/test.go: every live full/validator node reaches the
        final height and agrees on block hashes; light proxies serve
        verified headers matching the chain."""
        target = self.m.final_height
        heights = {}
        hashes = {}
        self._check_alive()
        for name in self.names:
            node = self.m.nodes[name]
            if node.mode == "light" or name in self.paused:
                continue
            if self.procs.get(name) is None or \
                    self.procs[name].poll() is not None:
                continue               # killed and never restarted
            port = self.rpc_port(name)
            end = time.monotonic() + 150
            while True:
                try:
                    st = await call(port, "status", timeout=120.0)
                except (OSError, asyncio.TimeoutError) as e:
                    raise RunnerError(
                        f"{name} rpc unreachable: {e}; last log lines:\n"
                        f"{self._log_tail(name)}") from e
                self._check_identity(name, st)
                heights[name] = st["sync_info"]["latest_block_height"]
                if heights[name] >= target:
                    break
                if time.monotonic() > end:
                    raise RunnerError(f"{name} stuck at {heights[name]} "
                                      f"< {target}")
                await asyncio.sleep(0.3)
            blk = await call(port, "block", height=target)
            hashes[name] = blk["block_id"]["hash"]["~b"]

        if len(set(hashes.values())) > 1:
            raise RunnerError(f"fork at {target}: {hashes}")

        light_ok = {}
        for name in self.names:
            if self.m.nodes[name].mode != "light":
                continue
            port = self.rpc_port(name)
            blk = await call(port, "block", height=target, timeout=60.0)
            got = blk["block_id"]["hash"]["~b"]
            if hashes and got not in set(hashes.values()):
                raise RunnerError(f"light {name} diverges at {target}")
            light_ok[name] = True

        # manifest validator_updates took effect: fold them over genesis
        # and compare with the live validator set
        validators = {}
        if self.m.validator_updates:
            expect = dict(self.m.validator_powers())
            for _, updates in sorted(self.m.validator_updates.items()):
                for name, power in updates.items():
                    if power == 0:
                        expect.pop(name, None)
                    else:
                        expect[name] = power
            port = self.rpc_port(self._primary_name())
            want = {self.node_pub_key_hex(n): p
                    for n, p in expect.items()}
            end = time.monotonic() + 30    # updates apply at height+2
            while True:
                vres = await call(port, "validators", timeout=60.0)
                got = {v["pub_key"]: v["voting_power"]
                       for v in vres["validators"]}
                if got == want:
                    break
                if time.monotonic() > end:
                    raise RunnerError(f"validator set mismatch: "
                                      f"want {want}, got {got}")
                await asyncio.sleep(0.5)
            validators = expect

        return {"final_height": target, "heights": heights,
                "agreement_hash": next(iter(hashes.values()), None),
                "light_verified": light_ok,
                "validators": validators}

    def node_pub_key_hex(self, name: str) -> str:
        """The node's validator pubkey (from its generated FilePV file)."""
        import json as _json

        with open(os.path.join(self.home(name), "config",
                               "priv_validator_key.json")) as f:
            return _json.load(f)["pub_key"]

    async def _submit_valset_tx(self, call, port: int, name: str,
                                power: int) -> None:
        """Manifest validator_update -> kvstore valset tx
        (val:<b64 pubkey>!<power>, abci/kvstore.py).  The power is
        zero-padded by a per-run sequence number so re-applying an
        earlier (name, power) pair still produces a unique tx — the
        mempool cache silently drops byte-identical resubmissions."""
        import base64

        self._valset_seq = getattr(self, "_valset_seq", 0) + 1
        pk = bytes.fromhex(self.node_pub_key_hex(name))
        padded = b"%0*d" % (len(str(power)) + self._valset_seq, power)
        tx = b"val:" + base64.b64encode(pk) + b"!" + padded
        self.log(f"[e2e] validator_update {name} -> power {power}")
        # ``call`` retries RPCError (incl. the RETRYABLE overload shed,
        # -32099) for its whole timeout window, so a loaded run resends
        # this control-plane tx instead of aborting
        res = await call(port, "broadcast_tx_sync", tx=tx.hex())
        if res.get("code", 0) != 0:
            raise RunnerError(f"valset tx for {name} rejected: {res}")

    def _log_tail(self, name: str, n: int = 15) -> str:
        try:
            with open(os.path.join(self.base_dir, f"{name}.log"),
                      errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return "(no log)"

    # --------------------------------------------------------- teardown

    def stop(self) -> None:
        for name, proc in self.procs.items():
            if proc.poll() is None:
                if name in self.paused:
                    proc.send_signal(signal.SIGCONT)
                proc.send_signal(signal.SIGTERM)
        for proc in list(self.procs.values()) + list(
                self.app_procs.values()):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
