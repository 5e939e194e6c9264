"""musicgen-medium: decoder-only over EnCodec tokens [arXiv:2306.05284].
Backbone only; the EnCodec frame frontend is a stub (input_specs provides
precomputed frame embeddings).  Sinusoidal positions, MHA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64, rope=False,
    frontend="frames",
)
