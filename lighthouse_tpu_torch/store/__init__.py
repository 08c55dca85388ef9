"""Block/state storage.

Counterpart of lighthouse/beacon_node/store: the
MemoryStore here plays the role of memory_store.rs for the in-process
harness; a hot/cold split can slot in behind the same Store interface.
"""

from .hot_cold import HotColdDB
from .memory import MemoryStore, Store

__all__ = ["HotColdDB", "MemoryStore", "Store"]
