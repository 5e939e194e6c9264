"""olmoe-1b-7b: 64 experts, top-8 [arXiv:2409.02060].
Dispatch bitmaps are 8-of-64 codes (paper k-of-N)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128, rope_theta=1e4,
    n_experts=64, n_shared_experts=0, top_k=8, moe_d_ff=1024,
)
