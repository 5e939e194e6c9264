"""Step functions: so far the serving half of the reference's
``src/repro/train/step.py`` (``serve_step``, ``prefill_step``)."""

from .step import prefill_step, serve_step

__all__ = ["prefill_step", "serve_step"]
