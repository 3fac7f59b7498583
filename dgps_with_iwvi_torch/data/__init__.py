"""Dataset layer: UCI regression registry, splits, normalization
(port of dgps_with_iwvi_tpu/data; numpy only)."""

from .datasets import (DEFAULT_DATA_DIR, UCI_REGISTRY, Dataset,
                       get_classification_data, get_multiclass_data,
                       get_regression_data)

__all__ = ["DEFAULT_DATA_DIR", "UCI_REGISTRY", "Dataset",
           "get_classification_data", "get_multiclass_data",
           "get_regression_data"]
