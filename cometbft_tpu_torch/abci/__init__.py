"""ABCI 2.0: the application interface (counterpart of
``cometbft_tpu/abci``; reference: ``abci/``), the in-process and socket
clients, the socket server, the call-grammar checker and the kvstore
application.  The gRPC server and client are in ``abci/grpc.py``."""

from .application import Application
from .client import ABCIClient, ABCIClientError, LocalClient, SocketClient
from .grammar import GrammarError, RecordingApp, check_sequence
from .kvstore import KVStoreApplication
from .server import ABCIServer
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
    "SocketClient", "ABCIServer", "GrammarError", "RecordingApp",
    "check_sequence", "KVStoreApplication",
    "CheckTxResponse", "CommitResponse", "Event", "EventAttribute",
    "ExecTxResult", "ExtendVoteResponse", "FinalizeBlockRequest",
    "FinalizeBlockResponse", "PrepareProposalRequest",
    "PrepareProposalResponse", "ProcessProposalRequest", "ValidatorUpdate",
    "VerifyVoteExtensionResponse", "CODE_TYPE_OK", "PROCESS_PROPOSAL_ACCEPT",
    "PROCESS_PROPOSAL_REJECT", "VERIFY_VOTE_EXT_ACCEPT",
    "VERIFY_VOTE_EXT_REJECT",
]
