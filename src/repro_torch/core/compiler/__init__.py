from repro_torch.core.compiler.tensor_dsl import Loop, Ref, Workload, split, reorder  # noqa: F401
from repro_torch.core.compiler.distribute import Mapping, distribute  # noqa: F401
from repro_torch.core.compiler.allocation import Allocation, allocate, adaptive_precision  # noqa: F401
from repro_torch.core.compiler.codegen import compile_workload  # noqa: F401
