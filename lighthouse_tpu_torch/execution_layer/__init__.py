"""Execution layer: Engine-API JSON-RPC client, JWT auth, engine fallback.

Counterpart of lighthouse/beacon_node/execution_layer (lib.rs:142-148
ExecutionLayer::from_config, engine_api/http.rs, the engines.rs fallback +
watchdog, and test_utils/'s mock EL server).
"""

from .engine_api import (
    EngineApiClient,
    EngineApiError,
    ExecutionLayer,
    PayloadStatus,
    jwt_token,
)
from .mock_el import MockExecutionEngine

__all__ = [
    "EngineApiClient",
    "EngineApiError",
    "ExecutionLayer",
    "MockExecutionEngine",
    "PayloadStatus",
    "jwt_token",
]
