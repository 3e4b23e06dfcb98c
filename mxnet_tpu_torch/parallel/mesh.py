"""Device meshes (counterpart: mxnet_tpu/parallel/mesh.py) as
``torch.distributed.device_mesh.DeviceMesh`` objects over the world that
``launch.py`` / ``parallel.dist`` started, one rank a device.

Axis names are the JAX package's: ``dp`` (data parallel), ``tp`` (tensor
parallel), ``pp`` (pipeline stages), ``sp`` (sequence), ``ep`` (experts).
``make_mesh({"dp": -1})`` infers the size from the world.  The mesh's
device type is ``cuda`` when the process has a card (every rank of a host
on its own card over NCCL, or all of them on one card over gloo, by
``dist.route()``), else ``cpu``.  A world of 1 gets a one-rank gloo group
(``dist.ensure_group``), so the same code runs in one process.

The axis helpers (``axis_names``, ``axis_size``, ``axis_rank``,
``axis_group``, ``axis_ranks``) read a mesh the way the step needs it: on
a ``dp x tp`` mesh (rank = d * tp + t) ``axis_group(mesh, "dp")`` is this
rank's dp slice (the ranks of its tp index) and ``axis_group(mesh, "tp")``
its tp slice.  ``make_pp_mesh`` is a ``dp x pp`` mesh with ``pp`` the minor
axis (rank = d * pp + s), and ``pp_submeshes`` cuts it into one
``StageMesh`` a stage: the ranks of the stage's ``dp`` slice, with that
slice's process group on its own ranks.

``set_sequence_mesh(mesh, axis)`` turns sequence parallelism on for the
process: every ``dot_product_attention`` then runs ``parallel.ring.
ring_attention`` over ``axis`` of ``mesh``, whose ranks run the same
replicated step (the rest of the graph is not sharded, as in the JAX
package, where only the op is).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["make_mesh", "data_parallel_mesh", "local_devices_for",
           "set_sequence_mesh", "sequence_mesh", "mesh_cache_key",
           "make_pp_mesh", "pp_submeshes", "StageMesh", "axis_names",
           "axis_size", "axis_rank", "axis_group", "axis_ranks"]


def _is_mesh(mesh):
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def axis_names(mesh):
    """The mesh's axis names, in order."""
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name):
    """The size of axis ``name`` (1 when the mesh has no such axis)."""
    names = axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_rank(mesh, name):
    """This rank's index along axis ``name``."""
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name):
    """The process group of this rank's slice along axis ``name``."""
    return mesh.get_group(name)


def axis_ranks(mesh, name):
    """The global ranks of this rank's slice along axis ``name``, in the
    axis's order."""
    grid = mesh.mesh
    names = axis_names(mesh)
    me = int(mesh.get_rank())
    coord = [int(c) for c in (grid == me).nonzero()[0].tolist()]
    ax = names.index(name)
    idx = tuple(slice(None) if i == ax else c for i, c in enumerate(coord))
    return [int(r) for r in grid[idx].reshape(-1).tolist()]


def mesh_cache_key(mesh):
    """A hashable identity of a mesh: axis names, sizes and ranks."""
    if mesh is None:
        return None
    return (axis_names(mesh), tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.reshape(-1).tolist()))


# the process's sequence mesh: when set, attention ops run ring attention
# over its axis (ops/attention.py)
_seq_mesh = {"mesh": None, "axis": "sp"}


def set_sequence_mesh(mesh, axis="sp"):
    """Turn sequence parallelism on (or off, with ``mesh=None``): later
    ``dot_product_attention`` ops run ring attention with the sequence
    split over ``axis`` of ``mesh`` (a ``make_mesh`` mesh over the ranks
    that run the same replicated step)."""
    if mesh is not None:
        if not _is_mesh(mesh):
            raise MXNetError("set_sequence_mesh takes a parallel.mesh mesh "
                             "(a torch DeviceMesh), got %r"
                             % type(mesh).__name__)
        if axis not in axis_names(mesh):
            raise MXNetError("set_sequence_mesh: mesh %r has no %r axis"
                             % (axis_names(mesh), axis))
    _seq_mesh["mesh"] = mesh
    _seq_mesh["axis"] = axis


def sequence_mesh():
    """(mesh, axis) of the active sequence mesh; mesh is None when off."""
    return _seq_mesh["mesh"], _seq_mesh["axis"]


def local_devices_for(ctx_list=None):
    """torch devices of ``ctx_list``; by default the one device this rank
    drives (its card over NCCL, card 0 when ranks share it, else the
    host)."""
    import torch
    from . import dist
    if ctx_list:
        return [c.torch_device() for c in ctx_list]
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if dist.route() == "nccl":
        return [torch.device("cuda", dist.local_rank())]
    return [torch.device("cuda", 0)]


def make_mesh(axes, devices=None):
    """A DeviceMesh from ``{axis_name: size}`` over the world's ranks (or
    the ranks listed in ``devices``); -1 infers one axis from the rank
    count.  Example: ``make_mesh({"dp": -1})``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from . import dist
    dist.ensure_group()
    world = dist.num_workers()
    ranks = list(range(world)) if devices is None \
        else [int(d) for d in devices]
    if any(r < 0 or r >= world for r in ranks):
        raise MXNetError("make_mesh: ranks %s outside the world of %d"
                         % (ranks, world))
    n = len(ranks)
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if n % known:
            raise MXNetError("cannot infer mesh axis: %d devices, known %d"
                             % (n, known))
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise MXNetError("mesh %r does not cover %d devices"
                         % (dict(zip(names, sizes)), n))
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(kind, torch.tensor(ranks, dtype=torch.int)
                      .reshape(sizes), mesh_dim_names=tuple(names))


def data_parallel_mesh(ctx_list=None):
    """A 1-D ``dp`` mesh over the world, one rank a device (``ctx_list``,
    when given, names one device a rank)."""
    from . import dist
    if ctx_list is not None and len(ctx_list) != dist.num_workers():
        raise MXNetError(
            "data_parallel_mesh: %d contexts for a world of %d ranks; the "
            "port's mesh holds one device a rank" % (len(ctx_list),
                                                    dist.num_workers()))
    return make_mesh({"dp": -1})


def make_pp_mesh(pp, dp=None, devices=None):
    """A ``dp x pp`` mesh for pipelined training (parity:
    mesh.make_pp_mesh): ``pp`` is the minor axis, so stage ``s`` owns the
    ranks ``d * pp + s`` of every dp index ``d``.  ``dp`` defaults to what
    the rank count leaves over."""
    return make_mesh({"dp": dp if dp is not None else -1, "pp": pp},
                     devices=devices)


class StageMesh(object):
    """One stage's slice of a pipeline mesh (what ``pp_submeshes`` gives):
    ``ranks`` the global ranks of its ``dp`` slice in dp order, ``shape``
    ``{"dp": len(ranks)}`` (or the remaining axes), and ``group`` that
    slice's process group on the ranks of the slice (None elsewhere)."""

    def __init__(self, index, ranks, names, shape, group):
        self.index = index
        self.ranks = list(ranks)
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.group = group

    def __repr__(self):
        return "StageMesh(%d, ranks=%r)" % (self.index, self.ranks)


def pp_submeshes(mesh, axis="pp"):
    """The stages of a pipeline mesh, one ``StageMesh`` an index of
    ``axis`` (parity: mesh.pp_submeshes): stage ``s`` of a ``dp x pp``
    mesh holds the dp slice ``mesh[:, s]``; a pure ``pp`` mesh gives
    one-rank stages with a ``dp`` axis of size 1."""
    if not _is_mesh(mesh):
        raise MXNetError("pp_submeshes takes a parallel.mesh mesh (a torch "
                         "DeviceMesh), got %r" % type(mesh).__name__)
    names = axis_names(mesh)
    if axis not in names:
        raise MXNetError("pp_submeshes: mesh %r has no %r axis"
                         % (names, axis))
    ax = names.index(axis)
    rest = tuple(n for n in names if n != axis)
    grid = mesh.mesh
    me = int(mesh.get_rank())
    subs = []
    for s in range(int(grid.shape[ax])):
        part = grid.select(ax, s)
        ranks = [int(r) for r in part.reshape(-1).tolist()]
        if not rest:
            sub_names, sub_shape, group = ("dp",), (1,), None
        else:
            sub_names, sub_shape = rest, tuple(int(x) for x in part.shape)
            group = None
            if me in ranks and len(rest) == 1:
                group = mesh.get_group(rest[0])
        subs.append(StageMesh(s, ranks, sub_names, sub_shape, group))
    return subs
