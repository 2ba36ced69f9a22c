"""ABCI 2.0: the application interface (counterpart of
``cometbft_tpu/abci``; reference: ``abci/``).  The in-process client;
the socket and gRPC clients and the kvstore application come with the
node slice of the port."""

from .application import Application
from .client import ABCIClient, ABCIClientError, LocalClient
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
    "CheckTxResponse", "CommitResponse", "Event", "EventAttribute",
    "ExecTxResult", "ExtendVoteResponse", "FinalizeBlockRequest",
    "FinalizeBlockResponse", "PrepareProposalRequest",
    "PrepareProposalResponse", "ProcessProposalRequest", "ValidatorUpdate",
    "VerifyVoteExtensionResponse", "CODE_TYPE_OK", "PROCESS_PROPOSAL_ACCEPT",
    "PROCESS_PROPOSAL_REJECT", "VERIFY_VOTE_EXT_ACCEPT",
    "VERIFY_VOTE_EXT_REJECT",
]
