"""Doppelganger protection: refuse to sign until the network has been quiet
about our validators for a full detection window.

Python rendering of lighthouse/validator_client/src/
doppelganger_service.rs:1-30: a newly-started VC watches
DEFAULT_REMAINING_DETECTION_EPOCHS complete epochs; if any of its validator
indices is seen attesting on the network during the window, another instance
of the same key is live (a "doppelganger") and signing stays disabled
permanently — double-signing is slashable, a missed epoch is not.
"""

from __future__ import annotations

DEFAULT_REMAINING_DETECTION_EPOCHS = 1


class DoppelgangerDetected(Exception):
    def __init__(self, validator_index: int, epoch: int):
        self.validator_index = validator_index
        self.epoch = epoch
        super().__init__(
            f"doppelganger: validator {validator_index} seen attesting at epoch "
            f"{epoch} during the detection window"
        )


class DoppelgangerService:
    def __init__(self, detection_epochs: int = DEFAULT_REMAINING_DETECTION_EPOCHS):
        self.detection_epochs = detection_epochs
        # validator_index -> (registration_epoch, first epoch signing allowed)
        self._window: dict[int, tuple[int, int]] = {}
        self._detected: dict[int, int] = {}  # index -> epoch seen

    def register(self, validator_index: int, current_epoch: int) -> None:
        """Start the watch: the current (partial) epoch does not count, so
        safety begins after `detection_epochs` FULL epochs
        (doppelganger_service.rs remaining-epochs accounting)."""
        self._window.setdefault(
            validator_index,
            (current_epoch, current_epoch + 1 + self.detection_epochs),
        )

    def observe_attestation(self, validator_index: int, epoch: int) -> None:
        """Feed from gossip/block attestation observation. Raises on
        detection (callers decide whether to shut down or just disable)."""
        window = self._window.get(validator_index)
        if window is None:
            return
        registered_at, safe_after = window
        # attestations targeting the registration epoch (or earlier) may be
        # this validator's OWN pre-restart messages still propagating — only
        # LATER epochs prove a concurrent signer (doppelganger_service.rs
        # ignores the startup epoch for the same reason)
        if registered_at < epoch < safe_after and validator_index not in self._detected:
            self._detected[validator_index] = epoch
            raise DoppelgangerDetected(validator_index, epoch)

    def allows_signing(self, validator_index: int, current_epoch: int) -> bool:
        if validator_index in self._detected:
            return False
        window = self._window.get(validator_index)
        if window is None:
            return True  # never registered: protection not enabled for it
        return current_epoch >= window[1]

    def detected(self) -> dict[int, int]:
        return dict(self._detected)
