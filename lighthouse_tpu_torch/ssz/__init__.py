"""SimpleSerialize (SSZ) encoding + Merkleization.

Rendering of the reference crates:
  consensus/ssz, consensus/ssz_derive  -> type-descriptor serialize/deserialize
  consensus/ssz_types                  -> Vector/List/Bitvector/Bitlist/Byte*
  consensus/tree_hash                  -> hash_tree_root / merkleize
(lighthouse/consensus/ssz/src/lib.rs, ssz_types/src/lib.rs,
tree_hash/src/lib.rs.)
"""

from .hash import (
    BYTES_PER_CHUNK,
    ZERO_HASHES,
    hash_pair,
    merkleize,
    mix_in_length,
    mix_in_selector,
    next_pow_of_two,
    pack_bytes,
)
from .types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    DeserializationError,
    List,
    Union,
    Vector,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
