"""Metric logging and the segmentation evaluator."""

from fedml_tpu_torch.metrics.segmentation import SegEvaluator
from fedml_tpu_torch.metrics.sink import MetricsSink

__all__ = ["MetricsSink", "SegEvaluator"]
