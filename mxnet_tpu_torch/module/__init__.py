"""The Module layer of the port (counterpart: mxnet_tpu/module): a Module
wraps a Symbol with its bound executor, parameters and optimizer, and
``fit`` trains it; a BucketingModule keeps a Module per sequence length
over one set of parameters.  SequentialModule and the Python modules wait
for the operator slice."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module",
           "BucketingModule"]
