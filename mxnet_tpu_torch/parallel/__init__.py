"""Parallel helpers of the port (counterpart: mxnet_tpu/parallel).

- ``dist``: the multi-process runtime on ``torch.distributed`` (rank,
  world, store barriers, the bucketed allreduce of the ``dist*`` stores);
- ``elastic``: failure detection and the checkpoint resume
  (``fit_elastic``);
- ``ring``: the single-device attention reference.

The device mesh and ZeRO placement, the pipeline schedules, ring attention
over a sequence mesh and the live resize arrive with the later parts of
the distributed slice.
"""
from . import dist
from . import elastic
from . import ring
