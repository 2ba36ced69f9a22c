"""abci subcommand group (counterpart of ``cometbft_tpu/cmd/abci.py``):
the reference's standalone ``abci-cli`` tool (``abci/cmd/abci-cli/
abci-cli.go``): poke any ABCI server over the socket protocol with
one-shot commands, a console REPL, or a batch script, run the example
kvstore server (over the socket protocol, or over gRPC with ``--grpc``:
``abci/grpc.py`` on the port's own HTTP/2), and run a conformance
sequence against an app.

Tx/data arguments accept the reference's literal forms: ``0xDEADBEEF`` is
hex, ``"quoted"`` is raw bytes, anything else is raw bytes too.
"""

from __future__ import annotations

import asyncio
import shlex
import sys

from ..abci import types as t


def parse_bytes(s: str) -> bytes:
    if s.startswith("0x") or s.startswith("0X"):
        return bytes.fromhex(s[2:])
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1].encode()
    return s.encode()


def _fmt(obj) -> str:
    """Render a response dataclass compactly, hex-ing byte fields."""
    if hasattr(obj, "__dataclass_fields__"):
        parts = []
        for k in obj.__dataclass_fields__:
            v = getattr(obj, k)
            if v in (None, b"", "", 0, [], False):
                continue
            parts.append(f"{k}: {_fmt(v)}")
        return "{" + ", ".join(parts) + "}"
    if isinstance(obj, bytes):
        return "0x" + obj.hex().upper()
    if isinstance(obj, list):
        return "[" + ", ".join(_fmt(v) for v in obj) + "]"
    return str(obj)


async def run_command(client, argv: list[str]) -> str:
    """Execute one abci-cli verb against a connected client; returns the
    printable result (raises on protocol errors)."""
    cmd, *args = argv
    if cmd == "echo":
        msg = args[0] if args else ""
        res = await client.echo(msg)
        return f"-> data: {res}"
    if cmd == "info":
        res = await client.info()
        return _fmt(res)
    if cmd == "check_tx":
        res = await client.check_tx(parse_bytes(args[0]))
        return f"-> code: {res.code}" + (f" log: {res.log}" if res.log else "")
    if cmd == "commit":
        res = await client.commit()
        return f"-> retain_height: {res.retain_height}"
    if cmd == "query":
        data = parse_bytes(args[0]) if args else b""
        path = args[1] if len(args) > 1 else "/key"
        res = await client.query(path, data, 0, False)
        out = f"-> code: {res.code}"
        if res.key:
            out += f" key: {res.key.decode('utf-8', 'replace')}"
        if res.value:
            out += f" value: {res.value.decode('utf-8', 'replace')}"
        return out
    if cmd == "finalize_block":
        txs = [parse_bytes(a) for a in args]
        res = await client.finalize_block(t.FinalizeBlockRequest(
            txs=txs, height=1, time_ns=0))
        lines = [f"-> code: {r.code}" +
                 (f" log: {r.log}" if r.log else "")
                 for r in res.tx_results]
        lines.append(f"-> app_hash: 0x{res.app_hash.hex().upper()}")
        return "\n".join(lines)
    if cmd == "prepare_proposal":
        txs = [parse_bytes(a) for a in args]
        res = await client.prepare_proposal(t.PrepareProposalRequest(
            max_tx_bytes=1 << 20, txs=txs, height=1, time_ns=0))
        return "\n".join(f"-> tx: 0x{tx.hex().upper()}" for tx in res.txs) \
            or "-> (no txs)"
    if cmd == "process_proposal":
        txs = [parse_bytes(a) for a in args]
        status = await client.process_proposal(t.ProcessProposalRequest(
            txs=txs, height=1, time_ns=0))
        return ("-> status: ACCEPT"
                if status == t.PROCESS_PROPOSAL_ACCEPT
                else "-> status: REJECT")
    raise ValueError(f"unknown command {cmd!r} (try: echo info check_tx "
                     f"commit query finalize_block prepare_proposal "
                     f"process_proposal)")


async def _connect(args):
    from ..abci.client import SocketClient

    host, _, port = args.address.removeprefix("tcp://").rpartition(":")
    if not port.isdigit():
        raise ValueError(f"bad --address {args.address!r}: "
                         f"expected host:port")
    return await SocketClient.connect(host or "127.0.0.1", int(port))


def cmd_abci(args) -> int:
    sub = args.abci_command
    if sub == "kvstore":
        return _run_kvstore(args)
    if sub == "test":
        return asyncio.run(_run_test(args))
    if sub in ("console", "batch"):
        return asyncio.run(_run_repl(args, interactive=(sub == "console")))
    return asyncio.run(_run_oneshot(args))


async def _run_oneshot(args) -> int:
    client = None
    try:
        client = await _connect(args)
        print(await run_command(client, [args.abci_command] + args.args))
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            await client.close()


async def _run_repl(args, interactive: bool) -> int:
    """console: interactive REPL; batch: same loop without prompts
    (abci-cli.go:155,178)."""
    try:
        client = await _connect(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rc = 0
    try:
        while True:
            if interactive:
                print("> ", end="", flush=True)
            line = await asyncio.get_event_loop().run_in_executor(
                None, sys.stdin.readline)
            if not line:
                break
            # posix=False keeps surrounding quotes, so parse_bytes can
            # distinguish "0xdead" (raw bytes) from 0xdead (hex)
            argv = shlex.split(line, comments=True, posix=False)
            if not argv:
                continue
            if argv[0] in ("quit", "exit"):
                break
            try:
                print(await run_command(client, argv))
            except Exception as e:
                print(f"error: {e}", file=sys.stderr)
                if not interactive:
                    rc = 1          # batch mode: first error stops the run
                    break
    finally:
        await client.close()
    return rc


def _run_kvstore(args) -> int:
    """Serve the example kvstore app over the ABCI socket protocol
    (abci-cli.go:266), or over gRPC with ``--grpc``; its app hash is
    computed on ``--device`` (the card by default)."""
    from ..abci.grpc import GRPCABCIServer
    from ..abci.kvstore import KVStoreApplication
    from ..abci.server import ABCIServer

    async def main():
        serve = GRPCABCIServer if args.grpc else ABCIServer
        server = serve(KVStoreApplication(device=args.device),
                       port=args.port)
        await server.start()
        print(f"ABCI kvstore server listening on "
              f"{server.host}:{server.port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


async def _run_test(args) -> int:
    """Conformance sequence against a kvstore-compatible server
    (abci-cli.go:274 runs the abci/tests suite)."""
    try:
        client = await _connect(args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    failures = 0

    async def check(name, got, want) -> None:
        nonlocal failures
        ok = got == want
        print(f"{'PASS' if ok else 'FAIL'} {name}: got {got!r}"
              + ("" if ok else f", want {want!r}"))
        failures += 0 if ok else 1

    try:
        await check("echo", await client.echo("hello"), "hello")
        info = await client.info()
        await check("info.last_block_height type",
                    isinstance(info.last_block_height, int), True)
        ct = await client.check_tx(b"conform=1")
        await check("check_tx valid", ct.code, 0)
        ct_bad = await client.check_tx(b"notakvtx")
        await check("check_tx invalid rejected", ct_bad.code != 0, True)
        fb = await client.finalize_block(t.FinalizeBlockRequest(
            txs=[b"conform=1"], height=info.last_block_height + 1,
            time_ns=0))
        await check("finalize_block tx code", fb.tx_results[0].code, 0)
        await check("finalize_block app_hash present",
                    len(fb.app_hash) > 0, True)
        await client.commit()
        q = await client.query("/key", b"conform", 0, False)
        await check("query committed value", q.value, b"1")
        print(f"{'OK' if failures == 0 else 'FAILED'}: "
              f"{failures} failure(s)")
        return 0 if failures == 0 else 1
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await client.close()


def register(sub) -> None:
    """Attach the abci command group to the top-level parser."""
    sp = sub.add_parser("abci", help="poke an ABCI server "
                        "(the reference's standalone abci-cli)")
    asub = sp.add_subparsers(dest="abci_command", required=True)
    oneshots = ("echo", "info", "check_tx", "commit", "query",
                "finalize_block", "prepare_proposal", "process_proposal")
    for name in oneshots + ("console", "batch", "test"):
        ap = asub.add_parser(name)
        ap.add_argument("--address", default="127.0.0.1:26658",
                        help="ABCI server host:port")
        if name in oneshots:
            ap.add_argument("args", nargs="*")
        ap.set_defaults(fn=cmd_abci)
    ap = asub.add_parser("kvstore", help="run the example kvstore app "
                         "as an ABCI socket (or --grpc) server")
    ap.add_argument("--port", type=int, default=26658)
    ap.add_argument("--grpc", action="store_true",
                    help="serve over gRPC instead of the socket protocol")
    ap.set_defaults(fn=cmd_abci)
