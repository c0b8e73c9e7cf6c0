"""repro_torch.launch — entry points (``python -m repro_torch.launch.train``)."""
