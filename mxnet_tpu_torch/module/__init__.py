"""The Module layer of the port (counterpart: mxnet_tpu/module): a Module
wraps a Symbol with its bound executor, parameters and optimizer, and
``fit`` trains it; a BucketingModule keeps a Module per sequence length
over one set of parameters; a SequentialModule chains modules, and a
PythonModule / PythonLossModule computes in the user's Python."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module",
           "BucketingModule", "SequentialModule", "PythonModule",
           "PythonLossModule"]
