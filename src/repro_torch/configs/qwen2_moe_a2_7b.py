"""qwen2-moe-a2.7b: 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].  Routed expert ff=1408; the 4 shared experts
are fused into one 5632-wide FFN.  Dispatch bitmaps are 4-of-60 codes —
the paper's k-of-N encoding (DESIGN.md §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128, rope_theta=1e6,
    n_experts=60, n_shared_experts=4, top_k=4,
    moe_d_ff=1408, shared_d_ff=5632,
)
