"""Qwen3-1.7B — dense decoder with qk-norm, GQA [hf:Qwen/Qwen3-8B family].

28L, d_model=2048, 16 heads (GQA kv=8), d_ff=6144, vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, qk_norm=True, mlp_variant="swiglu",
    source="hf:Qwen/Qwen3-8B",
)

REDUCED = ArchConfig(
    name="qwen3-1.7b-reduced", arch_type="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, qk_norm=True, mlp_variant="swiglu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="hf:Qwen/Qwen3-8B",
)
