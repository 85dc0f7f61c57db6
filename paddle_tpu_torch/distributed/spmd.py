"""Meshes, partition specs and placements: the port's counterpart of the
``jax.sharding`` names the model families use (``Mesh``,
``PartitionSpec``, ``NamedSharding``, ``with_sharding_constraint``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``("dp", "fsdp", "tp")``, ``("dp", "fsdp", "ep",
"tp")`` for MoE, ``("sp",)`` for the ring). A spec is :class:`P`, whose
text is the JAX ``PartitionSpec``'s, and :func:`placements` turns it into
DTensor placements on a mesh: a tensor dim named by an axis is
``Shard(dim)`` on that mesh dim (a tuple of axes shards the dim on each,
major to minor in mesh order, as JAX splits it), every other mesh dim is
``Replicate()``. :func:`constrain` is the reference's sharding constraint,
one explicit ``redistribute``.

The helpers that run a function on local shards (:func:`local`,
:func:`elementwise`, :func:`rowwise`, :func:`bias_add`) take plain
tensors too, and then just call it: one model body serves the mesh and
the single device, whose path is the plain calls, launch for launch.

:func:`init_group` starts the default process group: gloo on the CPU
(ranks as processes), and on the card a one-rank NCCL group over a
``HashStore``, the mesh of one that the card verifies. Nothing falls back
from the card to the CPU: :func:`make_mesh` on ``cuda`` without a card
raises.

Every redistribute and :func:`full` is counted, kind and per-device
bytes, in the monitor's comms plane (``monitor/comms.py``) when
``FLAGS_enable_monitor`` is on.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

from ..core import enforce as E
from ..core import flags as _flags
from ..core import resolve_device

_MONITOR = _flags.flag_info("enable_monitor")

__all__ = ["P", "make_mesh", "placements", "constrain", "shard",
           "replicate", "gather_axis", "local", "init_group", "is_dtensor",
           "full", "spec_of", "axis_size", "axis_rank", "partial_on", "matmul",
           "rowwise", "elementwise", "bias_add"]


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None`` (not
    sharded), an axis name, or a tuple of axis names. Frozen (a tuple);
    ``str`` gives the JAX ``PartitionSpec``'s text, which ``/sharding``
    compares."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        # the text of a tuple: one entry keeps its comma
        return "PartitionSpec" + tuple.__repr__(tuple(self))

    __str__ = __repr__


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of mesh axis ``name`` (1 without a mesh or axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 without it)."""
    if name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def init_group(backend: Optional[str] = None, *, init_method=None,
               rank: int = 0, world_size: int = 1):
    """Start the default process group unless one exists. ``backend``
    None means NCCL when a card is present, else gloo. NCCL without an
    ``init_method`` is the mesh of one: rank 0 of 1 over a ``HashStore``,
    on card 0 (``torch.cuda.set_device``). Gloo takes ``init_method``
    (e.g. ``file://...``), ``rank`` and ``world_size``, or the same
    one-rank ``HashStore``."""
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        resolve_device(None)        # raises without a card
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_method is None:
        E.enforce(world_size == 1,
                  "init_group: more than one rank needs an init_method",
                  error=E.InvalidArgumentError)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    return dist.group.WORLD


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device=None) -> DeviceMesh:
    """A device mesh of ``shape`` with axis ``names`` over the default
    group's ranks (``init_group`` starts a one-rank group when none
    exists). The default (``None``, or ``"cuda"``) needs a card and
    raises without one (``UnavailableError``); ``"cpu"`` is the gloo mesh
    of the tests."""
    if device is None or torch.device(device).type == "cuda":
        resolve_device(None)        # raises without a card
    dev = "cpu" if device is not None and torch.device(
        device).type == "cpu" else "cuda"
    E.enforce(len(shape) == len(names),
              f"make_mesh: shape {tuple(shape)} and names {tuple(names)} "
              f"differ in length", error=E.InvalidArgumentError)
    init_group("nccl" if dev == "cuda" else "gloo")
    return init_device_mesh(dev, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def placements(spec: Sequence, mesh: DeviceMesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that an entry names (a tuple entry names several, which must
    come in mesh order, JAX's major-to-minor split), ``Replicate()``
    on every other."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        E.enforce(idx == sorted(idx),
                  f"placements: axes {axes} of dim {dim} are not in the "
                  f"mesh's order {names}", error=E.InvalidArgumentError)
        for i in idx:
            E.enforce(isinstance(out[i], Replicate),
                      f"placements: mesh axis {names[i]!r} named twice in "
                      f"{spec}", error=E.InvalidArgumentError)
            out[i] = Shard(dim)
    return tuple(out)


def spec_of(x) -> P:
    """The partition spec of a DTensor's placements (``Partial`` reads as
    not sharded): the inverse of :func:`placements`."""
    mesh = x.device_mesh
    entries = [[] for _ in range(x.ndim)]
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return P(*[None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries])


def _count(src, dst, nbytes: int):
    """Count the collectives that take placements ``src`` to ``dst``,
    each moving ``nbytes`` a device (monitor on only)."""
    from ..monitor import comms as _comms
    for kind in _comms.placement_kinds(src, dst):
        _comms.record_collective(kind, nbytes)


def _redistribute(x, mesh, pls):
    out = x.redistribute(mesh, pls)
    if _MONITOR.value:
        local_t = out.to_local()
        _count(x.placements, out.placements,
               local_t.numel() * local_t.element_size())
    return out


def constrain(x, mesh: Optional[DeviceMesh], spec: Sequence):
    """The reference's ``with_sharding_constraint``: ``x`` redistributed
    to ``spec``'s placements; without a mesh ``x`` itself."""
    if mesh is None:
        return x
    return _redistribute(x, mesh, placements(spec, mesh))


def shard(x, mesh: DeviceMesh, spec: Sequence):
    """A full tensor (the same on every rank) as a DTensor placed by
    ``spec``; a DTensor is redistributed."""
    if isinstance(x, DTensor):
        return _redistribute(x, mesh, placements(spec, mesh))
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=None)


def replicate(x, mesh: DeviceMesh):
    """A tensor that is the same on every rank as a replicated DTensor
    (no communication)."""
    if isinstance(x, DTensor):
        return _redistribute(x, mesh, (Replicate(),) * mesh.ndim)
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def full(x):
    """The whole value of a DTensor as a plain tensor on this rank
    (``Partial`` placements reduced); a plain tensor itself."""
    if isinstance(x, DTensor):
        if any(isinstance(p, (Shard, Partial)) for p in x.placements):
            if _MONITOR.value:
                _count(x.placements, (Replicate(),) * x.device_mesh.ndim,
                       x.numel() * x.element_size())
            return x.full_tensor()
        return x.to_local()
    return x


def gather_axis(x, name: str):
    """``x`` with its shards on mesh axis ``name`` gathered (that mesh
    dim ``Replicate()``), every other placement kept: the ZeRO-3 gather
    of a weight over fsdp before use. A tensor that is not a DTensor, or
    a mesh without the axis, is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names or ()
    if name not in names:
        return x
    i = names.index(name)
    if isinstance(x.placements[i], Replicate):
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return _redistribute(x, x.device_mesh, tuple(pl))


def partial_on(x_or_placements, mesh: Optional[DeviceMesh], axes):
    """Placements (of a DTensor, or given) with each ``Replicate()`` on the
    mesh axes ``axes`` made ``Partial()``: what a local result holds when
    it sums over only this rank's part of a dim sharded on those axes
    (a weight's gradient from batch-sharded rows, an activation's from a
    tp shard of the weight). Without a mesh, None."""
    if mesh is None:
        return None
    pl = list(x_or_placements.placements if isinstance(x_or_placements,
                                                       DTensor)
              else x_or_placements)
    names = mesh.mesh_dim_names
    for a in axes:
        if a in names and isinstance(pl[names.index(a)], Replicate):
            pl[names.index(a)] = Partial()
    return tuple(pl)


def local(fn, mesh: Optional[DeviceMesh], out_spec, *args, grads=None):
    """``fn`` run on the local shards of the DTensors ``args`` (each
    taken as it is placed), its output wrapped back as a DTensor placed
    by ``out_spec`` (a spec, or a list of specs for a tuple output):
    the seam where a kernel meets a mesh. ``out_spec`` may also be
    placements themselves (``Partial`` among them), or None: placed as
    the first argument. ``grads`` gives, for each argument, the
    placements of the gradient that ``fn``'s backward computes locally
    (None: the argument's own; ``partial_on`` where the local gradient
    is a partial sum). Differentiable
    (``torch.distributed.tensor.experimental.local_map``). Without a
    mesh, ``fn(*args)``."""
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    if out_spec is None:
        out_spec = args[0].placements

    def placed(spec):
        # local_map reads a list as one output's placements
        if spec and all(isinstance(e, Placement) for e in spec):
            return list(spec)
        return list(placements(spec, mesh))

    if isinstance(out_spec, list):
        out = tuple(placed(s) for s in out_spec)
    else:
        out = placed(out_spec)
    ins = tuple(a.placements if isinstance(a, DTensor) else None
                for a in args)
    gin = ins if grads is None else tuple(
        i if g is None else tuple(g) for i, g in zip(ins, grads))
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=gin, device_mesh=mesh)(*args)


def matmul(x, w):
    """``x [..., K] @ w [K, N]`` of DTensors on their local shards, the
    output's placements derived here instead of by DTensor's sharding
    propagation (whose strategy search costs seconds of host time an op
    schema on a 3- or 4-axis mesh). On each mesh dim: ``x`` sharded on a
    leading dim with ``w`` replicated gives that shard (``w``'s gradient
    a partial sum); ``w`` sharded on N with ``x`` replicated gives the
    output's last dim sharded (``x``'s gradient partial); both sharded on
    K gives a partial sum (the row-parallel product); both replicated,
    replicated. Any other pairing is refused: place the operands first."""
    mesh = x.device_mesh
    last = x.ndim - 1
    out, gx, gw = [], list(x.placements), list(w.placements)
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        a_k = isinstance(a, Shard) and a.dim == last
        b_k = isinstance(b, Shard) and b.dim == 0
        if isinstance(a, Shard) and not a_k and isinstance(b, Replicate):
            out.append(a)
            gw[i] = Partial()
        elif isinstance(a, Replicate) and isinstance(b, Shard) and not b_k:
            out.append(Shard(last))
            gx[i] = Partial()
        elif a_k and b_k:
            out.append(Partial())
        elif isinstance(a, Replicate) and isinstance(b, Replicate):
            out.append(Replicate())
        else:
            raise E.InvalidArgumentError(
                f"spmd.matmul: operands placed {x.placements} @ "
                f"{w.placements} on mesh dim {i}: place them first")
    return local(torch.matmul, mesh, tuple(out), x, w, grads=[gx, gw])


def rowwise(fn, x, *weights):
    """``fn(x, *weights)`` on local shards, where ``fn`` works on the last
    dim of ``x`` (which must not be sharded) with replicated ``weights``
    of that dim (a norm's scale): the output is placed as ``x``, and each
    weight's gradient is a partial sum over the mesh dims that shard
    ``x``. A plain ``x``: ``fn(x, *weights)``."""
    if not isinstance(x, DTensor):
        return fn(x, *weights)
    mesh = x.device_mesh
    E.enforce(all(not (isinstance(p, Shard) and p.dim == x.ndim - 1)
                  for p in x.placements),
              f"spmd.rowwise: x placed {x.placements} is sharded on its "
              f"last dim", error=E.InvalidArgumentError)
    sharded = [n for n, p in zip(mesh.mesh_dim_names, x.placements)
               if isinstance(p, (Shard, Partial))]
    return local(fn, mesh, x.placements, x, *weights,
                 grads=[None] + [partial_on(w, mesh, sharded)
                                 for w in weights])


def elementwise(fn, *args):
    """``fn(*args)`` on local shards of DTensors that are all placed
    alike (an activation function, a residual add): the output is placed
    as the first. Plain tensors: ``fn(*args)``."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    mesh = args[0].device_mesh
    pl = args[0].placements
    E.enforce(all(a.placements == pl for a in args),
              f"spmd.elementwise: operands placed differently: "
              f"{[a.placements for a in args]}",
              error=E.InvalidArgumentError)
    return local(fn, mesh, pl, *args)


def bias_add(y, b):
    """``y + b`` on local shards, ``b`` a replicated bias of ``y``'s last
    dim: on a mesh dim that shards ``y``'s last dim the bias is sliced
    alike; the bias's gradient is a partial sum over the mesh dims that
    shard ``y``'s leading dims. Plain tensors: ``y + b``."""
    if not isinstance(y, DTensor):
        return y + b
    mesh = y.device_mesh
    last = y.ndim - 1
    E.enforce(not any(isinstance(p, Partial) for p in y.placements),
              "spmd.bias_add: reduce the partial sums first",
              error=E.InvalidArgumentError)
    b = _redistribute(b, mesh, tuple(
        Shard(0) if isinstance(p, Shard) and p.dim == last else Replicate()
        for p in y.placements))
    rows = [n for n, p in zip(mesh.mesh_dim_names, y.placements)
            if isinstance(p, Shard) and p.dim != last]
    return local(torch.add, mesh, y.placements, y, b,
                 grads=[None, partial_on(b, mesh, rows)])
