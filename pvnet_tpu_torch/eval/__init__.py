"""Evaluation: pose metrics and the accumulating evaluator."""

from pvnet_tpu_torch.eval.metrics import (  # noqa: F401
    add_error, add_error_sym, projection_error, projection_error_sym,
    cm_degree_errors)
from pvnet_tpu_torch.eval.evaluator import Evaluator, ObjectMeta  # noqa: F401
