"""Sharding-layout inspector: what does the mesh hold? (port of
``paddle_tpu/distributed/introspect.py``).

For any tree (nested dicts, lists, tuples) of tensors, plain or DTensor:

- :func:`describe_leaf`: the leaf's partition spec (the JAX
  ``PartitionSpec`` text of its placements, ``distributed.spmd.spec_of``),
  mesh axes, global against per-device shard bytes, the replication
  factor (``devices x shard elements / global elements``: 1 fully
  partitioned, the device count fully replicated) and whether it is
  fully replicated.
- :func:`describe_tree`: a bounded per-leaf report, totals, and the
  cross-device imbalance of the per-device byte totals, ``(max - min) /
  max``. The byte table covers every rank of each DTensor's mesh,
  computed from its placements (the shard sizes ``torch.chunk`` gives,
  as DTensor splits), as the reference computes it from each array's
  sharding, not only the local rank's shard.
- :func:`register_sharded_tree` / :func:`ensure_sharded_tree` /
  :func:`sharding_snapshot`: the ``/sharding`` route's feed (the serving
  engine registers its parameters). Registration is gated on the monitor
  flag: with it off nothing is computed or kept.

Paths are written as ``jax.tree_util.keystr`` writes them (``['layers']
['wq']``), devices as ``<type>:<global rank>``.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from . import spmd

__all__ = ["describe_leaf", "describe_tree", "register_sharded_tree",
           "ensure_sharded_tree", "unregister_sharded_tree",
           "sharding_snapshot", "reset"]

# Per-leaf reports are bounded; totals and imbalance cover every leaf.
_MAX_LEAVES = 256

_MU = threading.Lock()
_TREES: dict = {}
_MAX_TREES = 32


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _chunks(n: int, parts: int):
    """The sizes ``torch.chunk`` (DTensor's split) gives ``n`` elements
    over ``parts`` shards: ``ceil(n / parts)`` each, the last ones
    smaller or empty."""
    size = -(-n // parts) if parts else n
    return [max(0, min(size, n - i * size)) for i in range(parts)]


def _local_shape(shape, mesh, placements, coord):
    """A rank's shard shape at mesh coordinate ``coord``: each dim split
    by the mesh dims that shard it, in mesh order."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = _chunks(out[p.dim], mesh.size(i))[coord[i]]
    return out


def _rank_device(mesh, rank: int) -> str:
    return f"{mesh.device_type}:{rank}"


def _this_device(t) -> str:
    rank = dist.get_rank() if dist.is_initialized() else (
        t.device.index or 0)
    return f"{t.device.type}:{rank}"


def describe_leaf(arr, path: str = "") -> Optional[dict]:
    """Layout facts of one tensor (plain or DTensor), or None for a leaf
    that is not a tensor."""
    if not isinstance(arr, torch.Tensor):
        return None
    shape = tuple(int(d) for d in arr.shape)
    itemsize = arr.element_size()
    global_elems = math.prod(shape)
    out = {
        "path": path,
        "shape": list(shape),
        "dtype": _dtype_name(arr.dtype),
        "global_bytes": global_elems * itemsize,
        "spec": None,
        "mesh_axes": None,
        "num_devices": 1,
        "shard_shape": list(shape),
        "shard_bytes": global_elems * itemsize,
        "replication_factor": 1.0,
        "fully_replicated": True,
    }
    if not isinstance(arr, DTensor):
        return out
    mesh = arr.device_mesh
    n_dev = mesh.size()
    out["num_devices"] = n_dev
    out["spec"] = str(spmd.spec_of(arr))
    out["mesh_axes"] = {str(name): int(mesh.size(i)) for i, name in
                        enumerate(mesh.mesh_dim_names)}
    shard_shape = _local_shape(shape, mesh, arr.placements,
                               [0] * mesh.ndim)
    shard_elems = math.prod(shard_shape)
    out["shard_shape"] = shard_shape
    out["shard_bytes"] = shard_elems * itemsize
    if global_elems > 0:
        out["replication_factor"] = round(
            n_dev * shard_elems / global_elems, 4)
    out["fully_replicated"] = all(isinstance(p, Replicate)
                                  for p in arr.placements)
    return out


def _device_bytes(arr, per_device: dict):
    """Add each device's bytes of ``arr`` to ``per_device``: every rank of
    a DTensor's mesh from its placements, a plain tensor on this rank."""
    itemsize = arr.element_size()
    if not isinstance(arr, DTensor):
        key = _this_device(arr)
        per_device[key] = per_device.get(key, 0) + arr.numel() * itemsize
        return
    mesh = arr.device_mesh
    ranks = mesh.mesh
    for idx in range(ranks.numel()):
        coord = []
        rem = idx
        for size in reversed(ranks.shape):
            coord.append(rem % size)
            rem //= size
        coord = coord[::-1]
        n = math.prod(_local_shape(arr.shape, mesh, arr.placements, coord))
        key = _rank_device(mesh, int(ranks.reshape(-1)[idx]))
        per_device[key] = per_device.get(key, 0) + n * itemsize


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def describe_tree(tree, max_leaves: int = _MAX_LEAVES) -> dict:
    """Bounded per-leaf layout report, totals and cross-device imbalance
    of a tree of tensors."""
    leaves = []
    total_global = total_shard = n_arrays = replicated_bytes = 0
    per_device: dict = {}
    for path, x in _flatten(tree):
        d = describe_leaf(x, path)
        if d is None:
            continue
        n_arrays += 1
        total_global += d["global_bytes"]
        total_shard += d["shard_bytes"]
        if d["fully_replicated"] and d["num_devices"] > 1:
            replicated_bytes += d["global_bytes"]
        _device_bytes(x, per_device)
        if len(leaves) < max_leaves:
            leaves.append(d)
    imbalance = None
    if per_device:
        vals = list(per_device.values())
        mx, mn = max(vals), min(vals)
        imbalance = {
            "devices": len(per_device),
            "max_device_bytes": mx,
            "min_device_bytes": mn,
            "mean_device_bytes": int(sum(vals) / len(vals)),
            "relative_imbalance": round((mx - mn) / mx, 4)
            if mx > 0 else 0.0,
        }
    return {
        "leaves": leaves,
        "num_arrays": n_arrays,
        "truncated": n_arrays > len(leaves),
        "total_global_bytes": total_global,
        "total_shard_bytes_per_device": total_shard,
        "replicated_bytes": replicated_bytes,
        "imbalance": imbalance,
    }


def register_sharded_tree(name: str, tree) -> Optional[dict]:
    """Compute and keep a named tree's layout summary for ``/sharding``.
    Gated on the monitor flag: off, nothing is computed or kept.
    Re-registering a name refreshes it; the map keeps the newest 32."""
    from .. import monitor as _monitor

    if not _monitor.enabled():
        return None
    try:
        summary = describe_tree(tree)
    except Exception:
        return None
    with _MU:
        _TREES.pop(name, None)
        _TREES[name] = summary
        while len(_TREES) > _MAX_TREES:
            _TREES.pop(next(iter(_TREES)))
    return summary


def ensure_sharded_tree(name: str, tree_fn) -> bool:
    """Register ``tree_fn()`` under ``name`` unless it is registered: the
    engine's per-dispatch seam, so that a ``monitor.reset()`` mid-run
    fills ``/sharding`` again at the next dispatch. Monitor-gated."""
    from .. import monitor as _monitor

    if not _monitor.enabled():
        return False
    with _MU:
        if name in _TREES:
            return False
    return register_sharded_tree(name, tree_fn()) is not None


def unregister_sharded_tree(name: str):
    with _MU:
        _TREES.pop(name, None)


def sharding_snapshot() -> dict:
    """The ``/sharding`` payload: the world's shape (one device a
    process), the registered trees, and the program records that carry a
    sharding summary."""
    from ..monitor import programs as _programs

    world_size = dist.get_world_size() if dist.is_initialized() else 1
    world = {"devices": world_size, "local_devices": 1,
             "process_count": world_size}
    progs = []
    for rec in _programs.programs_snapshot():
        if rec.get("sharding") is not None:
            progs.append({"name": rec["name"], "source": rec["source"],
                          "signature": rec["signature"],
                          "sharding": rec["sharding"]})
    with _MU:
        trees = dict(_TREES)
    return {"world": world, "programs": progs, "trees": trees}


def reset():
    with _MU:
        _TREES.clear()
