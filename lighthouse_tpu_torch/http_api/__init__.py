"""Eth2 Beacon API server subset + metrics scrape (the roles of lighthouse's
http_api and http_metrics)."""

from .json_codec import decode, encode
from .server import ApiError, HttpApiServer

__all__ = ["ApiError", "HttpApiServer", "decode", "encode"]
