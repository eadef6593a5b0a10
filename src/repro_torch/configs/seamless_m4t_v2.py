"""SeamlessM4T-large-v2 backbone — encoder-decoder, multimodal
[arXiv:2308.11596].

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16, MHA),
d_ff=8192, vocab=256206, GELU FFN.  The speech frontend (mel +
conv feature extractor) is a STUB: ``frames (B, S_src, d_model)`` are
precomputed frame embeddings (assignment carve-out).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", arch_type="audio",
    n_layers=24, encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, mlp_variant="gelu",
    source="arXiv:2308.11596",
)

REDUCED = ArchConfig(
    name="seamless-m4t-reduced", arch_type="audio",
    n_layers=2, encoder_layers=2,
    d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, mlp_variant="gelu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2308.11596",
)
