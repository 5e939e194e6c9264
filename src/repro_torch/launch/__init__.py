"""Launchers: the model server (``python -m repro_torch.launch.serve``)."""
