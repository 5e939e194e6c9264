"""Runtime sanitizers (``REPRO_SANITIZE=1``), copied from the reference."""
