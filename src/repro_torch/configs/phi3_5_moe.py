"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=6400, vocab=32064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064, mlp_variant="swiglu",
    n_experts=16, moe_top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

REDUCED = ArchConfig(
    name="phi3.5-moe-reduced", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=256, vocab=512, mlp_variant="swiglu",
    n_experts=4, moe_top_k=2,
    param_dtype="float32", act_dtype="float32", remat=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
