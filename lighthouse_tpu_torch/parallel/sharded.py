"""Multi-GPU sharded BLS batch verification over `torch.distributed`.

The port of the JAX package's parallel/sharded.py. There, one controller
shards the staged sets over a device mesh with `shard_map`; each chip runs
the local pipeline and produces ONE Fp12 partial product plus a bool flag,
one all-gather moves the partials, and every chip runs the same final
exponentiation and ANDs the gathered flags.

torch.distributed has one process per rank, so the port is SPMD: every
rank of the process group calls `sharded_verify_signature_sets` with the
same sets.

  1. Every rank runs the structural check before any collective, so a
     batch that fails it returns False everywhere and no rank waits alone.
  2. Group rank 0 stages the batch (`stage_sets(..., s_floor=W)`, so S is
     a multiple of W whenever W is a power of two) and broadcasts S, K and
     the flat int32 staged buffer. Every rank then holds the batch and the
     RLC scalars the single controller would hold.
  3. Rank r takes rows [r S/W, (r+1) S/W) of each staged array and runs
     `verify_pipeline_local` on its device: K1-K4 on a card (K6 with the
     tensor-core flag), their plain versions on the CPU.
  4. The ranks all-gather their partials (one Fp12: 576 bytes) and their
     flags, and each runs `product_reduce` over the partials in rank order,
     `final_exponentiation` and `fp12_is_one`, and ANDs the flags. Every
     rank returns the same bool.

The collective backend is the one the caller's group has: NCCL with one
card per rank (collective buffers on the card), gloo on the CPU or for
ranks that share a card (collective buffers on the host). Nothing here
picks or switches it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..crypto.bls.torch_backend import api, pairing
from ..crypto.bls.torch_backend.tower import fp12_is_one


def make_mesh(n: int | None = None):
    """The process group to shard over: the default group, or a new group
    over global ranks 0..n-1. Like `dist.new_group`, every rank of the
    default group must call it, members or not."""
    if n is None or n == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def rank_device(device=None) -> torch.device:
    """This rank's device: `device`, else cuda:LOCAL_RANK (the global rank
    when LOCAL_RANK is not set). A CUDA device becomes the current device
    before any launch; without a GPU a CUDA device raises."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank()))}"
    dev = api.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _comm_device(group, dev: torch.device) -> torch.device:
    """Where the collective buffers live: on the card for NCCL, else on
    the host."""
    return dev if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _broadcast_staged(sets, group, rng, dev: torch.device):
    """Group rank 0 stages `sets` with s_floor = W and broadcasts S, K and
    the flat staged buffer. Returns (flat on `dev`, S, K) on every rank."""
    comm = _comm_device(group, dev)
    src = dist.get_global_rank(group, 0)
    header = torch.zeros(2, dtype=torch.int64, device=comm)
    flat = None
    if dist.get_rank(group) == 0:
        staged = api.stage_sets(sets, rng=rng, s_floor=dist.get_world_size(group))
        S, K = staged[2].shape
        header = torch.tensor([S, K], dtype=torch.int64, device=comm)
        flat = torch.from_numpy(api._pack_staged(staged)).to(comm)
    dist.broadcast(header, src=src, group=group)
    S, K = (int(v) for v in header.tolist())
    if flat is None:
        n = sum(int(torch.Size(shape).numel()) for shape, _ in api._staged_specs(S, K))
        flat = torch.empty(n, dtype=torch.int32, device=comm)
    dist.broadcast(flat, src=src, group=group)
    return flat.to(dev), S, K


def _all_gather(t: torch.Tensor, group, comm: torch.device) -> torch.Tensor:
    """The list form of `dist.all_gather` (gloo refuses the stacked one),
    stacked in group-rank order, on `t`'s device."""
    t = t.contiguous().to(comm)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def build_sharded_verify(group=None, device=None):
    """The counterpart of the JAX `build_sharded_verify(mesh)`: a function
    (flat, S, K) -> (gt, ok, partials) of the staged batch that every rank
    of `group` holds (on this rank's device), which runs this rank's rows
    and the cross-rank product. `gt` is the final exponentiation of the
    product of the partials (an Fp12, before `fp12_is_one`), `ok` the AND
    of every rank's flag, `partials` the (W, ...) gathered partials.

    There is no kernel cache, unlike the JAX module's `_kernel_cache`:
    PyTorch runs the pipeline eagerly, so there is no program to compile
    per (group, S, K)."""
    group = group if group is not None else dist.group.WORLD
    dev = torch.device(device) if device is not None else rank_device()
    comm = _comm_device(group, dev)
    W, r = dist.get_world_size(group), dist.get_rank(group)

    @torch.inference_mode()
    def kernel(flat: torch.Tensor, S: int, K: int):
        if S % W:
            raise ValueError(f"sharded verify: {W} ranks do not divide the S bucket {S}")
        rows = S // W
        local = tuple(a[r * rows : (r + 1) * rows] for a in api._unpack_staged(flat, S, K))
        partial, ok = api.verify_pipeline_local(*api._to_words(local))
        partials = _all_gather(partial, group, comm).to(dev)
        flags = _all_gather(ok.to(torch.int32).reshape(1), group, comm)
        gt = pairing.final_exponentiation(pairing.product_reduce(partials))
        return gt, bool(flags.all()), partials

    return kernel


def sharded_verify_parts(sets, group=None, rng=None, device=None):
    """(gt, ok, partials) of a structurally valid batch, sharded over
    `group` (see `build_sharded_verify`). Every rank calls it with the same
    sets; only group rank 0's `sets` and `rng` are read."""
    group = group if group is not None else dist.group.WORLD
    dev = rank_device(device)
    flat, S, K = _broadcast_staged(sets, group, rng, dev)
    return build_sharded_verify(group, dev)(flat, S, K)


def sharded_verify_signature_sets(sets, group=None, rng=None, device=None) -> bool:
    """`verify_signature_sets` semantics, executed across every rank of
    `group` (the default group when None): every rank calls it with the
    same sets and gets the same verdict. `device` is this rank's device
    (cuda:LOCAL_RANK by default, or "cpu"). Raises ValueError when the
    group's size does not divide the S bucket (a size that is not a power
    of two), as the JAX sharding does."""
    if not api._structurally_valid(sets):
        return False
    gt, ok, _ = sharded_verify_parts(sets, group, rng, device)
    return bool(fp12_is_one(gt)) and ok
