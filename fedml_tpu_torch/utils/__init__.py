"""Round checkpoints: ``utils/checkpoint.py``."""
