"""Parallel helpers of the port (counterpart: mxnet_tpu/parallel).

- ``dist``: the multi-process runtime on ``torch.distributed`` (rank,
  world, store barriers, the bucketed allreduce of the ``dist*`` stores);
- ``elastic``: failure detection and the checkpoint resume
  (``fit_elastic``);
- ``mesh``: device meshes (``torch.distributed`` DeviceMeshes over the
  world) with the JAX package's axis names;
- ``placement``: the ZeRO placement plan and its flat ``(dp, chunk)``
  layout;
- ``ring``: the single-device attention reference.

The pipeline schedules, ring attention over a sequence mesh and the live
resize arrive with the later parts of the distributed slice.
"""
from . import dist
from . import elastic
from . import mesh
from . import placement
from . import ring
