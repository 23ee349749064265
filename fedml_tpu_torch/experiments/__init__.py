"""Experiment entry points: ``python -m fedml_tpu_torch.experiments.run``."""
