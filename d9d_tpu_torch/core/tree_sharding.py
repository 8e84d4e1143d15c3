"""Declarative split of trees of tensors into N shards (counterpart of
``d9d_tpu/core/tree_sharding.py``: ``SpecShard``, ``SpecReplicate``,
``shard_spec_on_dim``, ``shard_tree``): the microbatch split
(``loop/components/batch_staging.py`` cuts every global batch into
microbatches, data-rank rows and context-rank chunks with it).

A tree is nested dicts, lists and tuples (``torch.utils._pytree``) whose
leaves are tensors, numpy arrays or anything else. A spec is one leaf spec
applied to every leaf, or a tree of the data's structure down to its spec
leaves: ``SpecShard(dim)`` cuts the unit (a tensor, an array, or a python
list or tuple on dim 0) into N equal chunks along ``dim``;
``SpecReplicate()`` gives every shard the same unit.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class SpecShard:
    dim: int = 0


@dataclasses.dataclass(frozen=True)
class SpecReplicate:
    pass


ShardingSpec = SpecShard | SpecReplicate


def _is_spec(x: Any) -> bool:
    return isinstance(x, (SpecShard, SpecReplicate))


def _is_unit(x: Any) -> bool:
    return isinstance(x, list)


def _broadcast_spec(tree: Any, spec: Any) -> Any:
    if _is_spec(spec):
        return pytree.tree_map(lambda _: spec, tree, is_leaf=_is_unit)
    return spec


def _shardable_on(leaf: Any, dim: int) -> bool:
    ndim = getattr(leaf, "ndim", None)
    if not ndim:
        return False
    return -ndim <= dim < ndim


def shard_spec_on_dim(tree: Any, dim: int = 0) -> Any:
    """Shard array leaves on ``dim`` and python lists on dim 0; replicate
    everything else."""

    def leaf_spec(leaf: Any) -> ShardingSpec:
        if isinstance(leaf, list):
            return SpecShard(0)
        return SpecShard(dim) if _shardable_on(leaf, dim) else SpecReplicate()

    return pytree.tree_map(leaf_spec, tree, is_leaf=_is_unit)


def _split_leaf(leaf: Any, s: SpecShard, n: int) -> list[Any]:
    if isinstance(leaf, (list, tuple)):
        if s.dim != 0 or len(leaf) % n:
            raise ValueError(f"cannot shard a sequence of length {len(leaf)} "
                             f"on dim {s.dim} into {n} chunks")
        step = len(leaf) // n
        return [leaf[i * step:(i + 1) * step] for i in range(n)]
    if not _shardable_on(leaf, s.dim):
        raise ValueError(f"cannot shard leaf {type(leaf).__name__} on dim "
                         f"{s.dim}")
    if leaf.shape[s.dim] % n:
        raise ValueError(f"cannot shard leaf of shape {tuple(leaf.shape)} on "
                         f"dim {s.dim} into {n} equal chunks")
    if isinstance(leaf, torch.Tensor):
        return list(torch.chunk(leaf, n, dim=s.dim))
    return list(np.split(np.asarray(leaf), n, axis=s.dim))


def _units(tree: Any, spec: Any) -> tuple[list, list, Any]:
    spec = _broadcast_spec(tree, spec)
    specs, treedef = pytree.tree_flatten(spec, is_leaf=_is_spec)
    units = treedef.flatten_up_to(tree)
    return specs, units, treedef


def shard_tree(tree: Any, spec: Any, num_shards: int) -> list[Any]:
    """``tree`` cut into ``num_shards`` trees as ``spec`` says."""
    specs, units, treedef = _units(tree, spec)
    per_unit = []
    for unit, s in zip(units, specs):
        if isinstance(s, SpecReplicate):
            per_unit.append([unit] * num_shards)
        elif isinstance(s, SpecShard):
            per_unit.append(_split_leaf(unit, s, num_shards))
        else:
            raise TypeError(f"unknown sharding spec leaf: {s!r}")
    return [pytree.tree_unflatten([u[i] for u in per_unit], treedef)
            for i in range(num_shards)]


__all__ = ["ShardingSpec", "SpecReplicate", "SpecShard", "shard_spec_on_dim",
           "shard_tree"]
