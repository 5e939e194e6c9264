"""Synthetic tables shaped like the paper's data sets."""
