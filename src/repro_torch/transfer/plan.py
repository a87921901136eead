"""Transfer plans: per-leaf trainer->pool transfer descriptions, coalesced
into fixed-size buckets (the weight-plane's unit of streaming). The port of
``src/repro/transfer/plan.py`` for one card: the JAX package's placement
specs (trainer and pool shardings over a mesh) are not ported, so every
leaf lands on the trainer's device.

A :class:`TransferPlan` records, per leaf, the storage and wire dtypes and
groups leaves into buckets of at most ``bucket_bytes`` wire bytes, so the
iteration-boundary weight push is a stream of bounded chunks:

  * a chunk can be in flight while the previous one is still landing (the
    service overlaps buckets with the trainer's iteration tail);
  * a destination flips to the new version only once EVERY bucket of that
    version has landed — partial trees are never observable.

Leaves larger than ``bucket_bytes`` get a bucket of their own (a leaf is
never split). Leaves are ordered by sorted key path, the order
``jax.tree_util`` flattens a dict in, so a plan's buckets are the JAX
package's buckets for the same tree.

Packing is value-preserving by default (``wire_dtype=None`` streams the
storage dtype: the pool receives the trainer's tensors themselves, which
nothing updates in place). An explicit ``wire_dtype`` (a bf16 payload while
f32 master weights stay trainer-side) casts on pack through
``kernels/transfer_cast.py`` and back on unpack, so the destination always
holds the storage dtype.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.transfer_cast import transfer_cast
from repro_torch.models.layers import dtype_of

_SEP = "::"


def flatten_with_keys(tree) -> Tuple[List[str], list]:
    """(path keys, leaves) of a nested dict, keys sorted at every level."""
    keys, leaves = [], []

    def walk(node, path):
        for k in sorted(node):
            v = node[k]
            p = f"{path}{_SEP}{k}" if path else str(k)
            if isinstance(v, dict):
                walk(v, p)
            else:
                keys.append(p)
                leaves.append(v)
    walk(tree, "")
    return keys, leaves


def unflatten(keys: Sequence[str], leaves: Sequence) -> dict:
    """Inverse of ``flatten_with_keys``."""
    tree: dict = {}
    for key, leaf in zip(keys, leaves):
        node = tree
        *path, last = key.split(_SEP)
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    key: str                      # tree path
    index: int                    # position in flatten order
    shape: tuple
    dtype: str                    # storage dtype (destination holds this)
    wire_dtype: str               # dtype on the wire (== dtype unless casting)
    wire_bytes: int


@dataclasses.dataclass(frozen=True)
class Bucket:
    bid: int
    indices: Tuple[int, ...]      # leaf indices (flatten order)
    wire_bytes: int


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    leaves: Tuple[LeafPlan, ...]
    buckets: Tuple[Bucket, ...]
    total_wire_bytes: int

    @property
    def keys(self) -> List[str]:
        return [lp.key for lp in self.leaves]


def build_plan(params, *, bucket_bytes: int,
               wire_dtype: Optional[str] = None) -> TransferPlan:
    """Compute the per-leaf plan and coalesce into buckets: greedy
    first-fit in flatten order, so the bucket list is a pure function of
    (tree structure, shapes, dtypes, bucket_bytes)."""
    assert bucket_bytes > 0, "bucket_bytes must be positive"
    keys, leaves = flatten_with_keys(params)
    plans: List[LeafPlan] = []
    for i, (k, leaf) in enumerate(zip(keys, leaves)):
        storage = _dtype_name(leaf.dtype)
        wire = wire_dtype or storage
        itemsize = torch.empty((), dtype=dtype_of(wire)).element_size()
        plans.append(LeafPlan(key=k, index=i, shape=tuple(leaf.shape),
                              dtype=storage, wire_dtype=wire,
                              wire_bytes=leaf.numel() * itemsize
                              if leaf.dim() else itemsize))

    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_bytes = 0
    for lp in plans:
        if cur and cur_bytes + lp.wire_bytes > bucket_bytes:
            buckets.append(Bucket(len(buckets), tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(lp.index)
        cur_bytes += lp.wire_bytes
    if cur:
        buckets.append(Bucket(len(buckets), tuple(cur), cur_bytes))
    return TransferPlan(leaves=tuple(plans), buckets=tuple(buckets),
                        total_wire_bytes=sum(l.wire_bytes for l in plans))


def pack_bucket(plan: TransferPlan, leaves: Sequence, bucket: Bucket) -> list:
    """Source side: the bucket's leaves as wire tensors — cast to the wire
    dtype by ``transfer_cast`` when the plan says so, the leaf itself
    otherwise (bitwise pass-through)."""
    out = []
    for i in bucket.indices:
        lp = plan.leaves[i]
        x = leaves[i]
        if lp.wire_dtype != lp.dtype:
            x = transfer_cast(x, dtype_of(lp.wire_dtype))
        out.append(x)
    return out


def unpack_bucket(plan: TransferPlan, bucket: Bucket, arrays: Sequence
                  ) -> List[Tuple[int, torch.Tensor]]:
    """Destination side: restore the storage dtype. Returns [(leaf index,
    tensor)] — the store splices these into its staging buffer."""
    out = []
    for i, x in zip(bucket.indices, arrays):
        lp = plan.leaves[i]
        if lp.wire_dtype != lp.dtype:
            x = x.to(dtype_of(lp.dtype))
        out.append((i, x))
    return out
