"""Evaluation: mixture test NLL / RMSE and the sqlite results database
(port of dgps_with_iwvi_tpu/evaluation)."""

from .database import Database
from .metrics import evaluate

__all__ = ["Database", "evaluate"]
