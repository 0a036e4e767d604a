"""Measurement scripts of the port, run on the card (``python -m keystone_tpu_torch.tools.<name>``)."""
