"""The optimizer: AdamW with a cosine schedule and global-norm clipping
(``adamw``), and int8 error-feedback gradient compression (``compress``)."""

from .adamw import OptConfig, apply_updates, init_opt_state, lr_schedule
from .compress import compress_grads, init_error_feedback, wire_bytes

__all__ = ["OptConfig", "apply_updates", "compress_grads",
           "init_error_feedback", "init_opt_state", "lr_schedule",
           "wire_bytes"]
