"""Parallel helpers of the port (counterpart: mxnet_tpu/parallel).  Only the
single-device attention reference is ported so far; ring attention over a
sequence mesh arrives with the distributed slice."""
