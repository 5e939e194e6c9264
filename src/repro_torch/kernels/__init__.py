"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes launchers
(one module per kernel), their plain PyTorch versions (``ref``) and the
wrappers the backend calls (``ops``)."""
