"""Set-up: process start, imports and CUDA initialisation, the table, the
index build, the kernels built or loaded and the warm-up batches."""


def read(run):
    return run.setup_s
