"""The Module layer of the port (counterpart: mxnet_tpu/module): a Module
wraps a Symbol with its bound executor, parameters and optimizer, and
``fit`` trains it.  BucketingModule waits for the sequences slice;
SequentialModule and the Python modules for the operator slice."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module"]
