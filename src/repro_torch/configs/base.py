"""Model configuration dataclass + registry for the assigned architectures
(a copy of the reference package's, pure data)."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 1e6
    sliding_window: int = 0      # 0 = full attention
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    route_sort: str = "none"     # "none" | "expert" | "grayfreq"
    moe_dispatch: str = "gather" # "gather" (optimized) | "scatter" (baseline)
    moe_capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0          # hybrid: shared attention block period
    # multimodal stubs
    frontend: str = "none"       # none | patch (vlm) | frames (audio)
    mrope_sections: tuple = (16, 24, 24)
    # numerics / impl
    dtype: str = "bfloat16"
    attn_impl: str = "blockwise"
    remat: bool = True
    remat_policy: str = "dots"   # "dots" (save matmul outs) | "full" (save nothing)
    # which input shapes this arch supports for the long-context cell
    subquadratic: bool = False   # True -> can run long_500k

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16 so vocab-sharding divides the
        production model axis (standard embedding padding)."""
        return -(-self.vocab_size // 16) * 16

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        kw = dict(
            n_layers=2, d_model=128, vocab_size=256,
            d_ff=256 if self.d_ff else 0,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)), head_dim=32)
        if self.frontend == "patch":
            kw.update(mrope_sections=(4, 6, 6))  # sums to head_dim/2 = 16
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=64,
                      shared_d_ff=128 if self.n_shared_experts else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_heads=4, ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=2)
        return replace(self, **kw)


_REGISTRY = [
    "qwen2_7b", "tinyllama_1_1b", "phi3_medium_14b", "qwen2_5_14b",
    "qwen2_vl_7b", "zamba2_1_2b", "qwen2_moe_a2_7b", "olmoe_1b_7b",
    "musicgen_medium", "mamba2_1_3b",
]

ARCH_IDS = [m.replace("_", "-").replace("qwen2-5", "qwen2.5")
            .replace("tinyllama-1-1b", "tinyllama-1.1b")
            .replace("phi3-medium-14b", "phi3-medium-14b")
            .replace("zamba2-1-2b", "zamba2-1.2b")
            .replace("qwen2-moe-a2-7b", "qwen2-moe-a2.7b")
            .replace("olmoe-1b-7b", "olmoe-1b-7b")
            .replace("mamba2-1-3b", "mamba2-1.3b")
            for m in _REGISTRY]


def get_config(arch: str) -> ModelConfig:
    """Look up an architecture by its public id (e.g. 'qwen2-7b')."""
    module_name = (
        arch.replace(".", "_").replace("-", "_")
    )
    mod = importlib.import_module(f"repro_torch.configs.{module_name}")
    return mod.CONFIG


def list_archs():
    return list(ARCH_IDS)
