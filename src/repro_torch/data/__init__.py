"""The data plane: synthetic tables shaped like the paper's data sets
(``tables``), the synthetic LM token pipeline (``tokens``) and the EWAH
index over its metadata (``metadata_index``)."""
