"""ABCI 2.0: the application interface (counterpart of
``cometbft_tpu/abci``; reference: ``abci/``), the in-process client and
the kvstore application.  The socket and gRPC clients come with the
networked node."""

from .application import Application
from .client import ABCIClient, ABCIClientError, LocalClient
from .kvstore import KVStoreApplication
from .types import (CODE_TYPE_OK, PROCESS_PROPOSAL_ACCEPT,
                    PROCESS_PROPOSAL_REJECT, VERIFY_VOTE_EXT_ACCEPT,
                    VERIFY_VOTE_EXT_REJECT, CheckTxResponse, CommitResponse,
                    Event, EventAttribute, ExecTxResult, ExtendVoteResponse,
                    FinalizeBlockRequest, FinalizeBlockResponse,
                    PrepareProposalRequest, PrepareProposalResponse,
                    ProcessProposalRequest, ValidatorUpdate,
                    VerifyVoteExtensionResponse)

__all__ = [
    "Application", "ABCIClient", "ABCIClientError", "LocalClient",
    "KVStoreApplication",
    "CheckTxResponse", "CommitResponse", "Event", "EventAttribute",
    "ExecTxResult", "ExtendVoteResponse", "FinalizeBlockRequest",
    "FinalizeBlockResponse", "PrepareProposalRequest",
    "PrepareProposalResponse", "ProcessProposalRequest", "ValidatorUpdate",
    "VerifyVoteExtensionResponse", "CODE_TYPE_OK", "PROCESS_PROPOSAL_ACCEPT",
    "PROCESS_PROPOSAL_REJECT", "VERIFY_VOTE_EXT_ACCEPT",
    "VERIFY_VOTE_EXT_REJECT",
]
