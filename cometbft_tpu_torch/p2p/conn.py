"""MConnection: N prioritized channels multiplexed over one
SecretConnection (counterpart of ``cometbft_tpu/p2p/conn.py``; reference:
``p2p/conn/connection.go:80,549,748``).

Per-channel bounded send queues; a send task picking the channel with the
lowest recently-sent/priority ratio (``selectChannelToGossipOn``
connection.go:549); packets of <= ``PACKET_PAYLOAD`` bytes with an eof bit
for message re-assembly; ping/pong keepalive with a pong deadline; flowrate
metering on both directions; optional one-way latency emulation.  The
packets are the JAX package's bytes.  With the fault plane armed
(``libs/failures.py``) the packet path runs the JAX package's sites:
``p2p.send.{drop,corrupt,delay,reorder,duplicate}`` a packet and
``p2p.recv.{drop,corrupt}`` a complete message, each with the
connection's ``chaos_scope`` (its node's name) as the ``node`` detail.
Rate limiting comes with a caller that sets a rate.
"""

from __future__ import annotations

import asyncio
import struct

from ..libs import clock, failures
from ..libs.flowrate import Monitor
from .reactor import ChannelDescriptor
from .secret_connection import SecretConnection

# a packet (3-byte header + payload) fits a single AEAD frame
# (DATA_LEN=1024) with headroom
PACKET_PAYLOAD = 1000
SEND_BATCH_PACKETS = 10             # connection.go:30 numBatchPacketMsgs
DEFAULT_PING_INTERVAL = 10.0
DEFAULT_PONG_TIMEOUT = 5.0

# Wire frames: a `<I` length prefix, then a 1-byte packet type; message
# packets add a 1-byte channel id, a 1-byte eof flag, and the payload
# chunk, struct-packed in one call.
_T_PING, _T_PONG, _T_MSG = 0x69, 0x6F, 0x6D        # 'i', 'o', 'm'
_MSG_HDR = struct.Struct("<IBBB")                  # len | type chan eof
_LEN = struct.Struct("<I")
_PING_FRAME = _LEN.pack(1) + bytes((_T_PING,))
_PONG_FRAME = _LEN.pack(1) + bytes((_T_PONG,))


class MConnectionError(Exception):
    pass


class PongTimeoutError(MConnectionError):
    """A ping went unanswered past the pong deadline — its own type so
    the Switch can count silent-death disconnects separately from
    protocol/transport errors."""


class ConnectionLostError(MConnectionError):
    """The underlying transport died (reset/EOF/OS error) — its own
    type so the Switch's misbehavior classifier never scores a plain
    network failure as peer misbehavior."""


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.queue: asyncio.Queue[bytes] = asyncio.Queue(
            desc.send_queue_capacity)
        self.sending: bytes | None = None      # partially-sent message
        self.sent_off = 0
        self.recent = 0.0                      # recently-sent counter
        self.recv_buf = bytearray()            # re-assembly buffer
        # plain-int telemetry, flushed to Prometheus by the Switch's
        # periodic sampler (never a labeled metric call per packet)
        self.sent_bytes = 0
        self.sent_msgs = 0
        self.recv_bytes = 0
        self.recv_msgs = 0
        self.queue_full_drops = 0

    @property
    def display_name(self) -> str:
        """The channel's telemetry key — /net_info dict keys, incident
        bundles and the Prometheus ``channel`` label all use this ONE
        spelling (gauge cleanup at peer removal matches on it)."""
        return self.desc.name or f"0x{self.desc.channel_id:02x}"

    def next_packet(self) -> tuple[bytes, bool]:
        """Carve the next <=PACKET_PAYLOAD chunk off the in-flight msg."""
        chunk = self.sending[self.sent_off:self.sent_off + PACKET_PAYLOAD]
        self.sent_off += len(chunk)
        eof = self.sent_off >= len(self.sending)
        if eof:
            self.sending = None
            self.sent_off = 0
        return chunk, eof

    def has_data(self) -> bool:
        return self.sending is not None or not self.queue.empty()


class MConnection:
    def __init__(self, conn: SecretConnection,
                 channels: list[ChannelDescriptor],
                 on_receive, on_error,
                 ping_interval: float = DEFAULT_PING_INTERVAL,
                 pong_timeout: float = DEFAULT_PONG_TIMEOUT,
                 emulated_latency: float = 0.0):
        self.conn = conn
        self.channels: dict[int, _Channel] = {
            d.channel_id: _Channel(d) for d in channels}
        self.on_receive = on_receive          # (chan_id, msg_bytes) -> None
        self.on_error = on_error              # (exc) -> None
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout
        self.send_monitor = Monitor()
        self.recv_monitor = Monitor()
        # one-way latency emulation (the reference injects tc-netem delays
        # between e2e containers, test/e2e/runner/latency_emulation.go;
        # here completed messages are dispatched after a timer so latency
        # rises without throttling bandwidth)
        self.emulated_latency = emulated_latency
        self._send_wakeup = asyncio.Event()
        # one packet held back by the p2p.send.reorder site
        self._chaos_held: dict | None = None
        # the fault sites' node selector (the switch stamps its node's
        # name: a rule with node=<name> arms one node's links)
        self.chaos_scope = ""
        self._pong_due: float | None = None
        self._pong_to_send = False
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        # --- telemetry (plain attrs; see telemetry()) -------------------
        now = clock.monotonic()
        self.created_mono = now
        self.last_recv_mono = now       # any complete packet counts
        self.last_msg_recv_mono = now   # complete channel messages only
        self.last_rtt_s: float | None = None
        self.pong_timeouts = 0
        self._ping_sent_mono: float | None = None
        # hook: Switch observes RTT samples into the node-labeled
        # histogram without MConnection knowing about metric labels
        self.on_rtt = None              # (rtt_seconds: float) -> None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._send_routine()),
            asyncio.create_task(self._recv_routine()),
            asyncio.create_task(self._ping_routine()),
        ]

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self.conn.close()

    def _fail(self, exc: Exception) -> None:
        if self._stopped:
            return
        self._stopped = True
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()
        self.conn.close()
        try:
            self.on_error(exc)
        except Exception:
            pass

    # ----------------------------------------------------------------- send

    def send(self, chan_id: int, msg: bytes) -> bool:
        """Enqueue; False if the channel is unknown or its queue is full
        (Peer.TrySend semantics — callers treat False as backpressure)."""
        ch = self.channels.get(chan_id)
        if ch is None or self._stopped:
            return False
        try:
            ch.queue.put_nowait(bytes(msg))
        except asyncio.QueueFull:
            ch.queue_full_drops += 1
            return False
        self._send_wakeup.set()
        return True

    def _select_channel(self) -> _Channel | None:
        """Lowest recently-sent/priority ratio wins (connection.go:549)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    async def _send_routine(self) -> None:
        try:
            # the loop re-checks _stopped rather than running until
            # cancelled: asyncio.wait_for (the idle wait below) can
            # swallow a cancellation that races with the wakeup event
            # (bpo-42130), and stop()'s `await t` would never return
            while not self._stopped:
                self._send_wakeup.clear()
                if self._pong_to_send:
                    self._pong_to_send = False
                    await self._write_frame(_PONG_FRAME)
                batch = 0
                while batch < SEND_BATCH_PACKETS:
                    ch = self._select_channel()
                    if ch is None:
                        break
                    if ch.sending is None:
                        ch.sending = ch.queue.get_nowait()
                        ch.sent_off = 0
                    chunk, eof = ch.next_packet()
                    if failures.armed_prefix("p2p.send.") or \
                            self._chaos_held is not None:
                        # the held-packet check releases a reordered
                        # packet with the next send even after the last
                        # p2p.send.* rule was disarmed
                        await self._chaos_send_packet(
                            ch, {"t": "m", "c": ch.desc.channel_id,
                                 "e": eof, "d": chunk})
                    else:
                        await self._write_frame(
                            _MSG_HDR.pack(len(chunk) + 3, _T_MSG,
                                          ch.desc.channel_id, eof) + chunk)
                    ch.recent += len(chunk)
                    ch.sent_bytes += len(chunk)
                    if eof:
                        ch.sent_msgs += 1
                    batch += 1
                # decay recently-sent so idle channels regain priority
                for ch in self.channels.values():
                    ch.recent *= 0.8
                if not any(c.has_data() for c in self.channels.values()) \
                        and not self._pong_to_send:
                    if self._chaos_held is not None:
                        # an idle wire must not strand a reordered packet
                        held, self._chaos_held = self._chaos_held, None
                        await self._write_packet(held)
                    try:
                        await clock.wait_for(self._send_wakeup.wait(), 0.5)
                    except asyncio.TimeoutError:
                        pass
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._fail(e)

    async def _chaos_send_packet(self, ch: _Channel, pkt: dict) -> None:
        """The send-side fault sites of one packet, in order:
        ``p2p.send.drop`` swallows it (the peer's reassembly sees a
        hole), ``p2p.send.corrupt`` flips one seeded bit of its payload,
        ``p2p.send.delay`` sleeps ``delay`` (50 ms by default) before the
        write, ``p2p.send.reorder`` holds it until after the next packet
        (or wire idle), ``p2p.send.duplicate`` writes it twice.  The
        caller's accounting proceeds regardless, as on a lossy link."""
        name = ch.display_name
        scope = self.chaos_scope
        if failures.fire("p2p.send.drop", chan=name,
                         node=scope) is not None:
            return
        f = failures.fire("p2p.send.corrupt", chan=name, node=scope)
        if f is not None and pkt["d"]:
            data = bytearray(pkt["d"])
            rng = failures.site_rng("p2p.send.corrupt")
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
            pkt = dict(pkt, d=bytes(data))
        f = failures.fire("p2p.send.delay", chan=name, node=scope)
        if f is not None:
            await clock.sleep(float(f.get("delay", 0.05)))
        f = failures.fire("p2p.send.reorder", chan=name, node=scope)
        if f is not None and self._chaos_held is None:
            self._chaos_held = pkt      # released after the next packet
            return
        await self._write_packet(pkt)
        if failures.fire("p2p.send.duplicate", chan=name,
                         node=scope) is not None:
            await self._write_packet(pkt)
        if self._chaos_held is not None:
            held, self._chaos_held = self._chaos_held, None
            await self._write_packet(held)

    async def _write_packet(self, packet: dict) -> None:
        """The fault sites' late encoder: the frames of the hot path."""
        d = packet.get("d", b"")
        await self._write_frame(
            _MSG_HDR.pack(len(d) + 3, _T_MSG, packet["c"],
                          1 if packet.get("e") else 0) + d)

    async def _write_frame(self, data: bytes) -> None:
        await self.conn.write(data)
        self.send_monitor.update(len(data))

    # ----------------------------------------------------------------- recv

    async def _recv_routine(self) -> None:
        try:
            while True:
                (n,) = _LEN.unpack(await self.conn.read(4))
                if n < 1 or n > PACKET_PAYLOAD + 256:
                    raise MConnectionError(f"bad packet length: {n}")
                raw = await self.conn.read(n)
                self.recv_monitor.update(n + 4)
                self.last_recv_mono = clock.monotonic()
                t = raw[0]
                if t == _T_MSG:
                    if n < 3:
                        raise MConnectionError("truncated message packet")
                    self._on_packet_msg(raw[1], raw[2], raw[3:])
                elif t == _T_PING:
                    self._pong_to_send = True
                    self._send_wakeup.set()
                elif t == _T_PONG:
                    self._pong_due = None
                    if self._ping_sent_mono is not None:
                        rtt = clock.monotonic() - self._ping_sent_mono
                        self._ping_sent_mono = None
                        self.last_rtt_s = rtt
                        if self.on_rtt is not None:
                            try:
                                self.on_rtt(rtt)
                            except Exception:
                                pass
                else:
                    raise MConnectionError(f"unknown packet type {t:#x}")
        except asyncio.CancelledError:
            raise
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self._fail(ConnectionLostError(f"connection lost: {e}"))
        except Exception as e:
            self._fail(e)

    def _on_packet_msg(self, chan_id: int, eof: int, data: bytes) -> None:
        ch = self.channels.get(chan_id)
        if ch is None:
            raise MConnectionError(f"unknown channel {chan_id}")
        ch.recv_buf.extend(data)
        ch.recv_bytes += len(data)
        if len(ch.recv_buf) > ch.desc.max_msg_size:
            raise MConnectionError(
                f"message exceeds max size on channel {ch.desc.channel_id}")
        if eof:
            msg = bytes(ch.recv_buf)
            ch.recv_buf.clear()
            ch.recv_msgs += 1
            self.last_msg_recv_mono = clock.monotonic()
            if failures.armed_prefix("p2p.recv."):
                # receive-side faults act on complete messages, the unit
                # a reactor sees: drop one, or flip one seeded bit
                if failures.fire("p2p.recv.drop", chan=ch.display_name,
                                 node=self.chaos_scope) is not None:
                    return
                f = failures.fire("p2p.recv.corrupt",
                                  chan=ch.display_name,
                                  node=self.chaos_scope)
                if f is not None and msg:
                    data = bytearray(msg)
                    rng = failures.site_rng("p2p.recv.corrupt")
                    data[rng.randrange(len(data))] ^= \
                        1 << rng.randrange(8)
                    msg = bytes(data)
            if self.emulated_latency > 0:
                # equal delays preserve delivery order (asyncio timer
                # heap breaks ties by schedule sequence)
                asyncio.get_running_loop().call_later(
                    self.emulated_latency, self._deliver_delayed,
                    ch.desc.channel_id, msg)
            else:
                self.on_receive(ch.desc.channel_id, msg)

    def _deliver_delayed(self, chan_id: int, msg: bytes) -> None:
        """Latency-emulated delivery with the same error semantics as the
        inline path: reactor exceptions fail the connection, and nothing
        is delivered after the connection stopped."""
        if self._stopped:
            return
        try:
            self.on_receive(chan_id, msg)
        except Exception as e:
            self._fail(e)

    # ----------------------------------------------------------------- ping

    async def _ping_routine(self) -> None:
        try:
            while True:
                await clock.sleep(self.ping_interval)
                await self._write_frame(_PING_FRAME)
                self._ping_sent_mono = clock.monotonic()
                self._pong_due = clock.monotonic() + self.pong_timeout
                await clock.sleep(self.pong_timeout)
                if self._pong_due is not None and \
                        clock.monotonic() >= self._pong_due:
                    self.pong_timeouts += 1
                    raise PongTimeoutError("pong timeout")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._fail(e)

    def telemetry(self) -> dict:
        """Full per-connection snapshot: per-channel counters + queue
        occupancy, flowrate on both directions, ping RTT and liveness
        ages.  Read-only over plain attrs — safe to call from RPC
        handlers and the watchdog while the connection runs."""
        now = clock.monotonic()
        channels = {}
        for ch in self.channels.values():
            channels[ch.display_name] = {
                "channel_id": ch.desc.channel_id,
                "sent_bytes": ch.sent_bytes,
                "sent_msgs": ch.sent_msgs,
                "recv_bytes": ch.recv_bytes,
                "recv_msgs": ch.recv_msgs,
                "send_queue": ch.queue.qsize(),
                "send_queue_capacity": ch.desc.send_queue_capacity,
                "queue_full_drops": ch.queue_full_drops,
            }
        return {
            "age_s": round(now - self.created_mono, 3),
            "send_bytes_total": self.send_monitor.total,
            "recv_bytes_total": self.recv_monitor.total,
            "send_rate": round(self.send_monitor.rate, 1),
            "recv_rate": round(self.recv_monitor.rate, 1),
            "last_recv_age_s": round(now - self.last_recv_mono, 3),
            "last_msg_recv_age_s": round(now - self.last_msg_recv_mono, 3),
            "last_rtt_s": (round(self.last_rtt_s, 6)
                           if self.last_rtt_s is not None else None),
            "pong_timeouts": self.pong_timeouts,
            "channels": channels,
        }
