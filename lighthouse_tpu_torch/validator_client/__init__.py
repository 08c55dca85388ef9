"""Validator client: duties, slashing-protected signing,
attestation/block services over the beacon-node API seam.
"""

from .http_client import BeaconApiError, BeaconNodeHttpClient
from .metrics_server import MetricsServer
from .slashing_protection import SlashingDatabase, SlashingProtectionError
from .validator_client import (
    AttesterDuty,
    BeaconNodeApi,
    ValidatorClient,
    ValidatorStore,
)

__all__ = [
    "BeaconApiError",
    "BeaconNodeHttpClient",
    "MetricsServer",
    "SlashingDatabase",
    "SlashingProtectionError",
    "AttesterDuty",
    "BeaconNodeApi",
    "ValidatorClient",
    "ValidatorStore",
]
