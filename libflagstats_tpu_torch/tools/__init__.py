"""Measurement tools of the port (python -m libflagstats_tpu_torch.tools.<name>)."""
