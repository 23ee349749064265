"""Metric logging."""

from fedml_tpu_torch.metrics.sink import MetricsSink

__all__ = ["MetricsSink"]
