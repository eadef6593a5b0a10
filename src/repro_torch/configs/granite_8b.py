"""Granite-8B-Code — dense llama-arch code model [arXiv:2405.04324].

36L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=49152, mlp_variant="swiglu",
    source="arXiv:2405.04324",
)

REDUCED = ArchConfig(
    name="granite-8b-reduced", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512, mlp_variant="swiglu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2405.04324",
)
