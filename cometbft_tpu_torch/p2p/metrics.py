"""P2P metric set (counterpart of ``cometbft_tpu/p2p/metrics.py``;
reference: ``p2p/metrics.go``).

One lazily-built process-wide set: in-process nodes share the default
registry, so every series carries a ``node`` label.  These are the JAX
package's node-labeled series (closed label sets: the number of
in-process nodes times a closed enum).  Its peer-labeled series, which a
periodic sampler flushes from the MConnection counters for Prometheus,
come with the Prometheus exposition; the counters themselves are read
directly (``MConnection.telemetry``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from ..libs import metrics as m

__all__ = ["PEER_LABEL_BUDGET", "peer_label", "p2p_metrics"]

# distinct peers a node's per-peer series may track at once
PEER_LABEL_BUDGET = 128


def peer_label(peer_id: str) -> str:
    """The bounded peer-label value: the 12-character id prefix the
    ``Peer.__repr__`` and log lines use."""
    return peer_id[:12]


@functools.cache
def p2p_metrics() -> SimpleNamespace:
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
    )
