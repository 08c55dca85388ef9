"""The repo's AST checkers (the JAX package's analysis/: lock guards, thread
hygiene, trace purity, metric names) over lighthouse_tpu_torch/, which now
holds threaded modules of its own (the beacon processor, the task executor,
the coalescer, the network's receive loops and servers, the Beacon API's
and the validator client's HTTP servers): 0 findings, with no allowlist. The checkers are the JAX
package's; the port does not import them."""

from pathlib import Path

import pytest

from lighthouse_tpu.analysis.engine import run_lints
from lighthouse_tpu.analysis.lints import (
    LockGuardChecker,
    MetricNameChecker,
    ThreadHygieneChecker,
    TracePurityChecker,
    default_checkers,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
THREADED = [
    "lighthouse_tpu_torch/scheduler/beacon_processor.py",
    "lighthouse_tpu_torch/common/task_executor.py",
    "lighthouse_tpu_torch/chain/attestation_processing.py",
    "lighthouse_tpu_torch/crypto/bls/batch_verifier.py",
    "lighthouse_tpu_torch/network/gossip.py",
    "lighthouse_tpu_torch/network/rpc.py",
    "lighthouse_tpu_torch/network/discovery.py",
    "lighthouse_tpu_torch/network/socket_net.py",
    "lighthouse_tpu_torch/network/peer_manager.py",
    "lighthouse_tpu_torch/http_api/server.py",
    "lighthouse_tpu_torch/validator_client/metrics_server.py",
    "lighthouse_tpu_torch/validator_client/web3signer.py",
]


def test_port_lints_clean():
    findings = run_lints(["lighthouse_tpu_torch"], default_checkers(), root=REPO_ROOT)
    assert not findings, "lint findings in the port:\n" + "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("checker", [LockGuardChecker, ThreadHygieneChecker, TracePurityChecker, MetricNameChecker],
                         ids=lambda c: c.__name__)
@pytest.mark.parametrize("path", THREADED)
def test_threaded_modules_lint_clean(checker, path):
    """Each checker alone over each threaded module of the port (the file
    exists: a moved module would make the gate vacuous)."""
    assert (REPO_ROOT / path).is_file(), path
    findings = run_lints([path], [checker()], root=REPO_ROOT)
    assert not findings, "\n".join(f.format() for f in findings)
