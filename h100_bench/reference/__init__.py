"""The plain reference: NumPy only, independent of the program.

It evaluates the benchmark's neutral predicate tuples densely over the
generated columns (:mod:`.evaluate`) and decodes and canonically encodes
EWAH streams from the format's definition (:mod:`.ewah`).  It imports no
module of the program and takes nothing the program made but the
answers it judges and the row order it checks.
"""
