"""Command-line examples of the port, run as
``python -m quick_tpu_torch.examples.<name>``."""
