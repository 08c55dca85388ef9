"""Eth1 caches and the endpoint seam."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ssz.merkle_proof import MerkleTree, deposit_root, deposit_tree_proof
from ..types import DEPOSIT_CONTRACT_TREE_DEPTH, ChainSpec
from ..types.containers import Deposit, DepositData, DepositMessage, Eth1Data


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    timestamp: int


class MockEth1Endpoint:
    """In-memory eth1 chain + deposit log source (the reference's
    execution_layer/test_utils mock server role for eth1)."""

    def __init__(self, genesis_timestamp: int = 1_500_000_000, seconds_per_block: int = 14):
        self.blocks: list[Eth1Block] = [
            Eth1Block(0, b"\x11" * 32, genesis_timestamp)
        ]
        self.seconds_per_block = seconds_per_block
        self.deposit_logs: list[tuple[int, DepositData]] = []  # (block_number, data)

    def mine_block(self) -> Eth1Block:
        prev = self.blocks[-1]
        blk = Eth1Block(
            prev.number + 1,
            bytes([prev.number + 1 & 0xFF]) * 32,
            prev.timestamp + self.seconds_per_block,
        )
        self.blocks.append(blk)
        return blk

    def submit_deposit(self, deposit_data: DepositData) -> None:
        self.deposit_logs.append((self.blocks[-1].number, deposit_data))

    # endpoint surface (eth1 JSON-RPC equivalents)
    def block_by_number(self, number: int) -> Eth1Block | None:
        return self.blocks[number] if 0 <= number < len(self.blocks) else None

    def latest_block(self) -> Eth1Block:
        return self.blocks[-1]

    def deposit_logs_in_range(self, lo: int, hi: int):
        return [(n, d) for n, d in self.deposit_logs if lo <= n <= hi]


class DepositCache:
    """deposit_cache.rs: every deposit ever seen (with its log block
    number), with an incrementally built contract tree. Proofs and roots
    are computed *at a given deposit_count* — the state's snapshot — never
    against the cache's current length (get_deposits takes deposit_count
    explicitly in the reference for exactly this reason)."""

    def __init__(self):
        self.deposits: list[DepositData] = []
        self.block_numbers: list[int] = []
        self.tree = MerkleTree([], DEPOSIT_CONTRACT_TREE_DEPTH)

    def add(self, dd: DepositData, block_number: int = 0) -> None:
        self.deposits.append(dd)
        self.block_numbers.append(block_number)
        self.tree.push(DepositData.hash_tree_root(dd))

    def __len__(self) -> int:
        return len(self.deposits)

    def count_at_block(self, block_number: int) -> int:
        """Deposits logged at or before `block_number`."""
        return sum(1 for n in self.block_numbers if n <= block_number)

    def _tree_at(self, count: int) -> MerkleTree:
        if count == len(self.deposits):
            return self.tree
        return MerkleTree(
            [DepositData.hash_tree_root(d) for d in self.deposits[:count]],
            DEPOSIT_CONTRACT_TREE_DEPTH,
        )

    def root(self, count: int | None = None) -> bytes:
        count = len(self.deposits) if count is None else count
        return deposit_root(self._tree_at(count), count)

    def deposits_for_block(self, start_index: int, count: int, deposit_count: int) -> list[Deposit]:
        """Proved deposits [start_index, start_index+count) against the
        `deposit_count`-leaf snapshot the target state committed to."""
        tree = self._tree_at(deposit_count)
        out = []
        for i in range(start_index, min(start_index + count, deposit_count)):
            out.append(
                Deposit(
                    proof=deposit_tree_proof(tree, i, deposit_count), data=self.deposits[i]
                )
            )
        return out


class Eth1Service:
    """service.rs: follows the endpoint, maintains the caches, answers
    eth1-vote queries."""

    def __init__(self, endpoint, follow_distance: int = 4):
        self.endpoint = endpoint
        self.follow_distance = follow_distance
        self.deposit_cache = DepositCache()
        self._synced_block = -1

    def update(self) -> None:
        """One poll: ingest new deposit logs up to the latest block."""
        latest = self.endpoint.latest_block().number
        for n, dd in self.endpoint.deposit_logs_in_range(self._synced_block + 1, latest):
            self.deposit_cache.add(dd, block_number=n)
        self._synced_block = latest

    def eth1_data_for_block(self) -> Eth1Data:
        """The eth1 vote: the block `follow_distance` behind the head with
        the deposit snapshot AS OF THAT BLOCK — count, root, and hash must
        describe the same point of the eth1 chain or no other honest node
        computes the same vote."""
        latest = self.endpoint.latest_block().number
        target = self.endpoint.block_by_number(max(0, latest - self.follow_distance))
        count = self.deposit_cache.count_at_block(target.number)
        return Eth1Data(
            deposit_root=self.deposit_cache.root(count),
            deposit_count=count,
            block_hash=target.hash,
        )


def make_deposit(bls, secret_key, amount: int, spec: ChainSpec) -> DepositData:
    """Build a correctly-signed DepositData (the deposit-contract client's
    signing path; deposit domain = genesis fork, zero validators root)."""
    import hashlib

    from ..types import compute_domain, compute_signing_root

    pk = secret_key.public_key()
    wc = b"\x00" + hashlib.sha256(pk.to_bytes()).digest()[1:]
    msg = DepositMessage(pubkey=pk.to_bytes(), withdrawal_credentials=wc, amount=amount)
    domain = compute_domain(spec.domain_deposit, spec.genesis_fork_version, b"\x00" * 32)
    root = compute_signing_root(msg, domain)
    return DepositData(
        pubkey=pk.to_bytes(),
        withdrawal_credentials=wc,
        amount=amount,
        signature=secret_key.sign(root).to_bytes(),
    )
