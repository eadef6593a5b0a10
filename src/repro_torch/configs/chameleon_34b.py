"""Chameleon-34B — early-fusion VLM over VQ image tokens [arXiv:2405.09818].

48L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=65536 (shared
text + VQ image codes), qk-norm.  Early fusion is at the TOKEN level: the
VQ image tokenizer (the stubbed frontend) maps images into the same vocab,
so the backbone consumes one mixed token stream — no separate patch
projector (contrast llama4_scout).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", arch_type="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536, qk_norm=True, mlp_variant="swiglu",
    source="arXiv:2405.09818",
)

REDUCED = ArchConfig(
    name="chameleon-34b-reduced", arch_type="vlm",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512, qk_norm=True, mlp_variant="swiglu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2405.09818",
)
