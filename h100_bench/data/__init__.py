"""Frozen copies of the table generators the port's tests use, so that a
change to the port cannot move the benchmark's data."""
