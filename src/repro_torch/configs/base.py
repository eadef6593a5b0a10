"""Architecture config schema, input-shape table and registry (port).

A copy of ``src/repro/configs/base.py``: ``get_arch`` imports
``repro_torch.configs.<id>``, so the port keeps its own schema and its
own config files.  Each ported ``<id>.py`` exports ``CONFIG`` (the
published sizes, source cited) and ``REDUCED`` (<=2 layers, d_model<=512)
for CPU tests.  ``remat`` wraps each layer of the pattern groups in
``torch.utils.checkpoint`` while a gradient is taken (the reference's
``jax.checkpoint``); ``scan_layers`` is the reference's ``lax.scan``
over layer groups, which the port keeps as a field: its layers are a
``ModuleList`` run in a loop, and the field only picks the reference's
parameter layout in ``convert.lm_params_to_reference``.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_arch",
           "list_archs", "ARCH_IDS", "PORTED_ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    mlp_variant: str = "swiglu"      # swiglu | gelu
    rope_theta: float = 10000.0
    # --- attention variant ---
    attn_window: int = 0             # 0 = full causal; >0 = sliding window
    long_context_window: int = 8192  # SWA window used for long_500k decode
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # --- hybrid layer pattern (cycled); remainder layers use pattern[0] ---
    block_pattern: tuple[str, ...] = ("attn",)   # attn | rec | rwkv
    local_window: int = 0            # window for attn blocks inside hybrid
    d_rnn: int = 0                   # RG-LRU width (0 -> d_model)
    # --- rwkv ---
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    # recurrent-core impl for rwkv/rec blocks:
    #   "" = default (chunked jnp rwkv, associative-scan rglru),
    #   "scan" = sequential oracle, "chunked" = jnp chunked,
    #   "pallas" = kernels/recurrent_scan fused path
    rec_impl: str = ""
    # --- enc-dec (audio) ---
    encoder_layers: int = 0          # >0 => encoder-decoder
    # --- vlm early fusion ---
    fuse_patches: bool = False       # input carries patch_embeds + mask
    patch_frac: float = 0.25         # fraction of seq positions that are image
    # --- numerics / compilation ---
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "jnp"           # jnp | pallas
    source: str = ""

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.block_pattern
        full = (pat * (self.n_layers // len(pat) + 1))[: self.n_layers]
        return tuple(full)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def rest_kinds(self) -> tuple[str, ...]:
        rem = self.n_layers - self.n_groups * len(self.block_pattern)
        return tuple(self.block_pattern[0] for _ in range(rem))

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_layer = 0
        for kind in self.layer_kinds:
            if kind == "attn":
                attn = (self.n_heads + 2 * self.n_kv_heads) \
                    * self.head_dim * d + self.n_heads * self.head_dim * d
                if self.n_experts:
                    ff = self.n_experts * (3 if self.mlp_variant == "swiglu"
                                           else 2) * d * f + d * self.n_experts
                else:
                    ff = (3 if self.mlp_variant == "swiglu" else 2) * d * f
                per_layer += attn + ff
            elif kind == "rec":
                dr = self.d_rnn or d
                per_layer += 2 * d * dr + 2 * dr * dr + dr * d
            elif kind == "rwkv":
                per_layer += 5 * d * d + 2 * d * f + d * d
        emb = v * d * (2 if self.encoder_layers == 0 else 2)
        if self.encoder_layers:
            # encoder blocks: attn + mlp, plus decoder cross-attn
            enc = self.encoder_layers * (
                4 * self.n_heads * self.head_dim * d
                + (3 if self.mlp_variant == "swiglu" else 2) * d * f)
            cross = self.n_layers * 4 * self.n_heads * self.head_dim * d
            per_layer = per_layer  # decoder layers already counted
            return emb + per_layer + enc + cross
        return emb + per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        n_ff_all = len([k for k in self.layer_kinds if k == "attn"]) \
            * self.n_experts * (3 if self.mlp_variant == "swiglu" else 2) * d * f
        n_ff_active = n_ff_all // self.n_experts * self.moe_top_k
        return self.n_params() - n_ff_all + n_ff_active


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "codeqwen1_5_7b", "recurrentgemma_9b", "granite_8b", "rwkv6_1_6b",
    "phi3_5_moe", "qwen3_1_7b", "chameleon_34b", "deepseek_67b",
    "seamless_m4t_v2", "llama4_scout",
    # the paper's own models
    "paper_cnn", "paper_mlp",
]

_ALIASES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-8b": "granite_8b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen3-1.7b": "qwen3_1_7b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-67b": "deepseek_67b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "llama4-scout-17b-a16e": "llama4_scout",
}


#: The LM configs the port carries: every LM id of the reference.
PORTED_ARCH_IDS = tuple(a for a in ARCH_IDS if not a.startswith("paper_"))


def get_arch(arch_id: str, reduced: bool = False):
    """Load CONFIG (or REDUCED) from ``repro_torch.configs.<id>``."""
    arch_id = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return getattr(mod, "REDUCED" if reduced else "CONFIG")


def list_archs() -> list[str]:
    return list(ARCH_IDS)
