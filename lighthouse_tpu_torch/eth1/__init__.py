"""Eth1 deposit-contract follower.

Counterpart of lighthouse/beacon_node/eth1/src: a block cache + a
deposit cache fed by an `Eth1Endpoint` seam (the JSON-RPC boundary; tests
and the simulator use the in-memory `MockEth1Endpoint`, matching how the
reference tests against ganache). `Eth1Service.eth1_data_for_block`
computes the eth1 vote (the follow-distance block + deposit snapshot).
"""

from .json_rpc import JsonRpcEth1Endpoint, MockEth1RpcServer
from .service import DepositCache, Eth1Block, Eth1Service, MockEth1Endpoint, make_deposit

__all__ = [
    "DepositCache",
    "Eth1Block",
    "Eth1Service",
    "JsonRpcEth1Endpoint",
    "MockEth1Endpoint",
    "MockEth1RpcServer",
    "make_deposit",
]
