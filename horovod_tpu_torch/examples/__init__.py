"""Example trainers of the port (``python -m
horovod_tpu_torch.examples.<name>``)."""
