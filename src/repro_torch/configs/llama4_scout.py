"""Llama-4-Scout-17B-16E — MoE (16 experts, top-1), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model=5120, 40 heads (GQA kv=8), per-expert d_ff=8192,
vocab=202048.  Early fusion via projected patch embeddings scattered into
the token stream (the vision encoder is the stubbed frontend:
``patch_embeds (B, P, d_model)``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, mlp_variant="swiglu",
    n_experts=16, moe_top_k=1,
    fuse_patches=True, patch_frac=0.25,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

REDUCED = ArchConfig(
    name="llama4-scout-reduced", arch_type="moe",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, mlp_variant="swiglu",
    n_experts=4, moe_top_k=1,
    fuse_patches=True, patch_frac=0.25,
    param_dtype="float32", act_dtype="float32", remat=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
