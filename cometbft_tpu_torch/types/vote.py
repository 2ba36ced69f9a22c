"""Vote types (reference: ``types/vote.go``); counterpart of the constants
of ``cometbft_tpu/types/vote.py`` that commit sign bytes need.  The
``Vote`` object and its gossip path come with the consensus slice."""

from __future__ import annotations

from . import canonical

__all__ = ["PREVOTE_TYPE", "PRECOMMIT_TYPE"]

PREVOTE_TYPE = canonical.SIGNED_MSG_TYPE_PREVOTE
PRECOMMIT_TYPE = canonical.SIGNED_MSG_TYPE_PRECOMMIT
