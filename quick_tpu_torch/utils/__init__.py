"""Checkpoint IO of the port: the safetensors format and the native,
HF-float and AutoAWQ checkpoints."""
