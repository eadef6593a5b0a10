"""CodeQwen1.5-7B — dense decoder, qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads (MHA: kv=32), d_ff=13440, vocab=92416.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416, mlp_variant="swiglu",
    source="hf:Qwen/CodeQwen1.5-7B",
)

REDUCED = ArchConfig(
    name="codeqwen1.5-7b-reduced", arch_type="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab=512, mlp_variant="swiglu",
    param_dtype="float32", act_dtype="float32", remat=False,
    source="hf:Qwen/CodeQwen1.5-7B",
)
