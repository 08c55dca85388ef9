"""Greedy weighted maximum-coverage packing.

Python rendering of lighthouse/beacon_node/operation_pool/src/
max_cover.rs:48 (maximum_cover) + merge_solutions:99: pick k sets
maximizing covered weight; after each pick, re-score remaining candidates
against the uncovered universe only. The greedy algorithm is the standard
(1 - 1/e)-approximation the reference uses.
"""

from __future__ import annotations

from typing import Callable, Iterable, TypeVar

T = TypeVar("T")


def maximum_cover(
    items: Iterable[T],
    covering: Callable[[T], dict],
    limit: int,
) -> list[T]:
    """Select up to `limit` items maximizing total weight of covered keys.

    covering(item) -> {key: weight}; an item's score is the sum of weights
    of its keys not yet covered by earlier picks. Items whose residual
    score hits zero are dropped (max_cover.rs: update_covering_set)."""
    candidates = [(item, dict(covering(item))) for item in items]
    chosen: list[T] = []
    covered: set = set()
    for _ in range(limit):
        best_idx = -1
        best_score = 0
        for i, (_, cov) in enumerate(candidates):
            score = sum(w for k, w in cov.items() if k not in covered)
            if score > best_score:
                best_idx, best_score = i, score
        if best_idx < 0:
            break
        item, cov = candidates.pop(best_idx)
        chosen.append(item)
        covered |= set(cov)
    return chosen
