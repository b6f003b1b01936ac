"""Measurement scripts of the port, run as ``python -m
video_gpt_tpu_torch.scripts.<name>``."""
