"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954].

95L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", arch_type="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400, mlp_variant="swiglu",
    source="arXiv:2401.02954",
)

REDUCED = ArchConfig(
    name="deepseek-67b-reduced", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512, mlp_variant="swiglu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2401.02954",
)
