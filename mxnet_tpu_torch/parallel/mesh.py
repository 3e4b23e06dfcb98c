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
``axis_group``) read a mesh the way the step needs it.  Not ported here:
the pipeline meshes (``make_pp_mesh``, ``pp_submeshes``) and the sequence
mesh of ring attention (``set_sequence_mesh``) raise, naming their parts of
the distributed slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["make_mesh", "data_parallel_mesh", "local_devices_for",
           "set_sequence_mesh", "sequence_mesh", "mesh_cache_key",
           "make_pp_mesh", "pp_submeshes", "axis_names", "axis_size",
           "axis_rank", "axis_group"]


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


def mesh_cache_key(mesh):
    """A hashable identity of a mesh: axis names, sizes and ranks."""
    if mesh is None:
        return None
    return (axis_names(mesh), tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.reshape(-1).tolist()))


def set_sequence_mesh(mesh, axis="sp"):
    """Clear (``mesh=None``) the sequence mesh; a mesh raises: ring
    attention over a sequence mesh is not ported yet."""
    if mesh is not None:
        raise MXNetError("set_sequence_mesh is not ported yet: it arrives "
                         "with the ring-attention part of the distributed "
                         "slice")


def sequence_mesh():
    """(mesh, axis) of the sequence mesh: always (None, "sp") here."""
    return None, "sp"


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
    raise MXNetError("make_pp_mesh is not ported yet: it arrives with the "
                     "pipeline part of the distributed slice")


def pp_submeshes(mesh, axis="pp"):
    raise MXNetError("pp_submeshes is not ported yet: it arrives with the "
                     "pipeline part of the distributed slice")
