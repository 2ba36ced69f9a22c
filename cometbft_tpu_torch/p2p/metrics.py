"""P2P metric set (counterpart of ``cometbft_tpu/p2p/metrics.py``;
reference: ``p2p/metrics.go``).

One lazily-built process-wide set: in-process nodes share the default
registry, so every series carries a ``node`` label.  Two tiers, as in
the JAX package:

- node-labelled series (dial failures, handshakes, ping RTT, reactor
  messages, misbehaviour, bans, pong timeouts, reconnect give-ups):
  closed label sets, the in-process nodes times a closed enum;
- peer-labelled series (per-peer, per-channel throughput, queue depth
  and drops, rates, RTT, score): open under churn, so each is made with
  a label budget (:data:`PEER_LABEL_BUDGET`, times the channels for the
  channel-split ones) past which the oldest child is evicted.  The
  switch's telemetry routine writes them from the MConnection's plain
  counters, never the packet path.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from ..libs import metrics as m

__all__ = ["PEER_LABEL_BUDGET", "peer_label", "p2p_metrics"]

# distinct peers a node's per-peer series may track at once
PEER_LABEL_BUDGET = 128
# channel-split per-peer series carry peer x channel children
_CHANNELS_PER_PEER = 8


def peer_label(peer_id: str) -> str:
    """The bounded peer-label value: the 12-character id prefix the
    ``Peer.__repr__`` and log lines use."""
    return peer_id[:12]


@functools.cache
def p2p_metrics() -> SimpleNamespace:
    chan_budget = PEER_LABEL_BUDGET * _CHANNELS_PER_PEER
    return SimpleNamespace(
        peers=m.gauge(
            "p2p_peers",
            "connected peers by direction (inbound|outbound)"),
        dial_failures=m.counter(
            "p2p_dial_failures_total",
            "outbound dial attempts that failed before a peer was added"),
        handshake_failures=m.counter(
            "p2p_handshake_failures_total",
            "transport upgrades (secret handshake + NodeInfo exchange) "
            "that failed, by direction"),
        handshake_seconds=m.histogram(
            "p2p_handshake_seconds",
            "transport upgrade latency: TCP established -> peer proven "
            "and compatible, by direction",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0)),
        ping_rtt_seconds=m.histogram(
            "p2p_ping_rtt_seconds",
            "MConnection ping->pong round-trip time",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0)),
        pong_timeouts=m.counter(
            "p2p_pong_timeouts_total",
            "peers dropped because a ping went unanswered past the pong "
            "deadline"),
        reactor_msgs=m.counter(
            "p2p_reactor_msgs_total",
            "complete messages dispatched to each reactor"),
        queue_full_drops=m.counter(
            "p2p_send_queue_full_total",
            "sends refused because the per-channel send queue was full, "
            "by channel (backpressure visible per channel, node-wide)"),
        misbehavior=m.counter(
            "p2p_peer_misbehavior_total",
            "misbehavior events reported to the peer scorer, by typed "
            "event (see p2p/quality.py taxonomy)"),
        peer_bans=m.counter(
            "p2p_peer_bans_total",
            "timed bans issued by the peer scorer, by the event that "
            "tipped the score over the ban threshold"),
        reconnect_giveups=m.counter(
            "p2p_reconnect_giveups_total",
            "persistent-peer reconnect loops that exhausted the "
            "exponential backoff budget (they keep retrying at the max "
            "delay; this counts the downshifts)"),
        # ---------------------------------------------- peer-labelled
        peer_send_bytes=m.counter(
            "p2p_peer_send_bytes_total",
            "bytes of message payload sent to a peer, by channel",
            max_label_sets=chan_budget),
        peer_recv_bytes=m.counter(
            "p2p_peer_recv_bytes_total",
            "bytes of message payload received from a peer, by channel",
            max_label_sets=chan_budget),
        peer_send_msgs=m.counter(
            "p2p_peer_send_msgs_total",
            "complete messages sent to a peer, by channel",
            max_label_sets=chan_budget),
        peer_recv_msgs=m.counter(
            "p2p_peer_recv_msgs_total",
            "complete messages received from a peer, by channel",
            max_label_sets=chan_budget),
        peer_queue_depth=m.gauge(
            "p2p_peer_send_queue",
            "send-queue depth (messages waiting) per peer channel",
            max_label_sets=chan_budget),
        peer_queue_drops=m.counter(
            "p2p_peer_send_queue_full_total",
            "queue-full send drops per peer channel",
            max_label_sets=chan_budget),
        peer_send_rate=m.gauge(
            "p2p_peer_send_rate_bytes",
            "flowrate send EMA (bytes/sec, idle-decaying) per peer",
            max_label_sets=PEER_LABEL_BUDGET),
        peer_recv_rate=m.gauge(
            "p2p_peer_recv_rate_bytes",
            "flowrate recv EMA (bytes/sec, idle-decaying) per peer",
            max_label_sets=PEER_LABEL_BUDGET),
        peer_rtt=m.gauge(
            "p2p_peer_rtt_seconds",
            "last measured ping RTT per peer",
            max_label_sets=PEER_LABEL_BUDGET),
        peer_score=m.gauge(
            "p2p_peer_score",
            "decaying misbehavior score per connected peer (0 = clean; "
            "crossing the configured thresholds disconnects / bans)",
            max_label_sets=PEER_LABEL_BUDGET),
    )
