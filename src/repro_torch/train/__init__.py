"""Step functions: a copy of the reference's ``src/repro/train/step.py``
(``cross_entropy``, ``loss_fn``, ``train_step``, ``eval_step``,
``serve_step``, ``prefill_step``)."""

from .step import (cross_entropy, eval_step, loss_fn, prefill_step,
                   serve_step, train_step)

__all__ = ["cross_entropy", "eval_step", "loss_fn", "prefill_step",
           "serve_step", "train_step"]
