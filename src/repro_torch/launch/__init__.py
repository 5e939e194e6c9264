"""Launchers: the model server (``python -m repro_torch.launch.serve``) and
the trainer (``python -m repro_torch.launch.train``), with the meshes both
take (``mesh``) and the reference's input shapes (``shapes``)."""
