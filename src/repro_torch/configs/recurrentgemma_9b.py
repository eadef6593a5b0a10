"""RecurrentGemma-9B — hybrid RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427].

38L, d_model=4096, 16 heads (MQA: kv=1), d_ff=12288, vocab=256000,
local attention window 2048, RG-LRU width = d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, mlp_variant="swiglu",
    block_pattern=("rec", "rec", "attn"), local_window=2048, d_rnn=4096,
    source="arXiv:2402.19427",
)

REDUCED = ArchConfig(
    name="recurrentgemma-9b-reduced", arch_type="hybrid",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, head_dim=64,
    d_ff=512, vocab=512, mlp_variant="swiglu",
    block_pattern=("rec", "attn"), local_window=64, d_rnn=256,
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2402.19427",
)
