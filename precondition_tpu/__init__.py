"""precondition_tpu: a preconditioning-optimizer framework in JAX.

Second-order preconditioned optimizers (distributed Shampoo, SM3,
Sketchy/frequent-directions, quantized state) built on JAX/XLA: SPMD over
`jax.sharding.Mesh` and batched matrix numerics over stacked ``[N, m, m]``
statistics.

Capability parity target: google-research/precondition (see SURVEY.md).
"""

__version__ = "0.1.0"

from precondition_tpu.ops.pth_root import (
    inverse_pth_root,
    matrix_inverse_pth_root,
    matrix_inverse_pth_root_eigh,
    power_iteration,
    mat_power,
    pth_root_difference,
    RootMetrics,
)
from precondition_tpu.utils.shapes import (
    merge_small_dims,
    pad_square_matrix,
    pad_vector,
    BlockPartitioner,
)
from precondition_tpu.utils.quantization import QuantizedValue
from precondition_tpu.optim.sm3 import sm3
from precondition_tpu.optim.shampoo import (
    distributed_shampoo,
    GraftingType,
    PreconditionerType,
    Preconditioner,
    ShampooState,
)
