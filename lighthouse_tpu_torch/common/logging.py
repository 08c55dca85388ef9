"""Structured key-value logging.

Counterpart of lighthouse/common/logging (slog wrappers): loggers
carry bound context key-values (per-module context loggers,
environment/src/lib.rs:15-17), emit `msg key=value ...` lines through the
stdlib logging machinery, and a `test_logger` collects records for
assertions.
"""

from __future__ import annotations

import logging
import sys
import time


class KvLogger:
    def __init__(self, name: str = "lighthouse_tpu", _base: logging.Logger | None = None, **bound):
        self._logger = _base or logging.getLogger(name)
        self._bound = bound

    def bind(self, **kv) -> "KvLogger":
        """Return a child logger with extra bound context (slog's `o!`)."""
        merged = {**self._bound, **kv}
        return KvLogger(self._logger.name, _base=self._logger, **merged)

    def _fmt(self, msg: str, kv: dict) -> str:
        parts = [msg]
        for k, v in {**self._bound, **kv}.items():
            if isinstance(v, bytes):
                v = "0x" + v.hex()[:16]
            parts.append(f"{k}={v}")
        return " ".join(parts)

    def debug(self, msg: str, **kv):
        self._logger.debug(self._fmt(msg, kv))

    def info(self, msg: str, **kv):
        self._logger.info(self._fmt(msg, kv))

    def warning(self, msg: str, **kv):
        self._logger.warning(self._fmt(msg, kv))

    def error(self, msg: str, **kv):
        self._logger.error(self._fmt(msg, kv))

    def crit(self, msg: str, **kv):
        self._logger.critical(self._fmt(msg, kv))


def setup_logging(level: str = "info", stream=None) -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper()),
        stream=stream or sys.stderr,
        format="%(asctime)s %(levelname)-5s %(name)s %(message)s",
    )


def test_logger() -> tuple[KvLogger, list]:
    """Logger + captured records list (common/logging test_logger)."""
    records: list[str] = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    base = logging.getLogger(f"lighthouse_tpu.test.{time.monotonic_ns()}")
    base.setLevel(logging.DEBUG)
    base.addHandler(_Capture())
    base.propagate = False
    return KvLogger(base.name, _base=base), records


LOG = KvLogger()
