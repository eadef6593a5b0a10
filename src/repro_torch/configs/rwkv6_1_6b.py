"""RWKV-6 "Finch" 1.6B — attention-free SSM with data-dependent decay
[arXiv:2404.05892].

24L, d_model=2048, d_ff=7168, vocab=65536, head_size 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=7168, vocab=65536,
    block_pattern=("rwkv",), rwkv_head_dim=64, rwkv_chunk=64,
    source="arXiv:2404.05892",
)

REDUCED = ArchConfig(
    name="rwkv6-1.6b-reduced", arch_type="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=512, vocab=512,
    block_pattern=("rwkv",), rwkv_head_dim=32, rwkv_chunk=16,
    param_dtype="float32", act_dtype="float32", remat=False,
    source="arXiv:2404.05892",
)
