"""mamba2-1.3b: attention-free SSD [arXiv:2405.21060].
48 mamba2 layers, d_state=128, tied embeddings, sub-quadratic."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, rope=False,
    ssm_state=128, ssm_heads=64, ssm_groups=1, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True, subquadratic=True,
)
