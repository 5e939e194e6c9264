"""zamba2-1.2b: Mamba2 backbone + ONE shared (attn+MLP) block applied every
6 mamba layers (weight-tied) [arXiv:2411.15242].  d_ff is the shared block's
MLP width.  Long-context: shared attention uses a 4096 sliding window at
500k (DESIGN.md §Arch-applicability)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64, rope_theta=1e4,
    ssm_state=64, ssm_heads=64, ssm_groups=1, ssm_expand=2, ssm_chunk=128,
    attn_every=6, subquadratic=True,
)
