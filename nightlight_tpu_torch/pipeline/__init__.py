"""Operator/job layer: the JSON job format (operator ``type`` tags shared
with the JAX package), the execution context and the operators."""

# Importing the operator modules registers every operator type.
from nightlight_tpu_torch.pipeline import operators  # noqa: F401
from nightlight_tpu_torch.pipeline import ops_pre  # noqa: F401
from nightlight_tpu_torch.pipeline import ops_ref  # noqa: F401
from nightlight_tpu_torch.pipeline import ops_post  # noqa: F401
from nightlight_tpu_torch.pipeline import ops_stack  # noqa: F401
from nightlight_tpu_torch.pipeline.context import Context  # noqa: F401
from nightlight_tpu_torch.pipeline.operators import (  # noqa: F401
    OpLoad, OpLoadMany, OpSave, OpSequence, Operator, get_operator_factory,
    materialize_all, op_from_dict)
