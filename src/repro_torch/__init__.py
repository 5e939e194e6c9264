"""PyTorch/CUDA port of the histogram-aware compressed bitmap index.

The host side (histogram-aware row and column orders, encodings, the EWAH
codec and the query planner) is a copy of the reference package's numpy
code; query execution runs on a CUDA card through hand-written kernels
(``kernels/``, sources in ``csrc/``).  This package imports torch, numpy
and the standard library only, never jax and never the reference package.
"""
