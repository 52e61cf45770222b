"""The port's copy of the config system: the ``ModelConfig`` dataclass.

Field for field the same dataclass as the JAX package's
``configs/base.py``, so a config built on either side has the same
values. ``get_config``/``get_reduced`` resolve modules inside
``repro_torch.configs``. The port carries the ViT config, the four
dense causal LMs (``llama3_2_3b``, ``qwen2_5_3b``, ``gemma_2b``,
``internlm2_1_8b``), the ssm ``mamba2_2_7b``, the hybrid
``hymba_1_5b``, the moe ``mixtral_8x7b`` and ``grok_1_314b``, the
vlm ``internvl2_2b`` and the audio encoder-decoder ``whisper_small``,
each with its ``reduced()`` form: every config of the JAX package. It
also carries the ``ssm_moe`` family's ``granite_4_0_h_small``, whose
fields beyond ``ModelConfig``'s are on the subclass ``SSMMoEConfig``.

It also carries the reference's input-shape matrix (``InputShape``,
``INPUT_SHAPES``, ``ARCH_IDS``, ``skip_reason``, ``all_combos``), which
the cost model (``repro_torch.roofline``) reads.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | vit
                                     # (ssm_moe: SSMMoEConfig below)
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MLP / norm flavour ---
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 2.0
    # --- attention windowing ---
    sliding_window: int = 0          # 0 = full attention
    long_context_window: int = 8192
    # --- sharding variants (kept for field parity with the reference)
    decode_cache_shard: str = "heads"
    adam_moment_dtype: str = "float32"
    attn_block_skip: bool = False
    batch_shard_axes: tuple = ()
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_dim: int = 4
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # --- VLM ---
    n_patches: int = 0
    # --- ViT classifier (the paper's own model) ---
    n_classes: int = 0
    image_size: int = 32
    patch_size: int = 4
    # --- SuperSFL knobs (paper defaults) ---
    split_depth: int = 0             # 0 -> n_layers // 4 (min 1)
    tpgf_variant: str = "full"       # full | no_loss | no_depth | equal (Fig.6)
    tpgf_clip: float = 0.5
    tpgf_eps: float = 1e-8
    agg_lambda: float = 0.01
    alloc_alpha: float = 0.5
    alloc_beta: float = 4.0
    # --- runtime ---
    dtype: str = "float32"           # activations/params dtype for this config
    remat: bool = False
    # in the port: flash, the scan, aggregate, tier_sum (and fuse on
    # sharded gradients) take their hand-written kernels; TPGF's Phase 3
    # runs sumsq and fuse on the card whatever this says
    use_pallas: bool = False
    microbatches: int = 1

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def resolved_split_depth(self) -> int:
        stack = self.n_enc_layers if self.is_encdec else self.n_layers
        d = self.split_depth or max(stack // 4, 1)
        return min(max(d, 1), stack - 1) if stack > 1 else 1

    @property
    def split_stack_len(self) -> int:
        return self.n_enc_layers if self.is_encdec else self.n_layers

    @property
    def split_stack_name(self) -> str:
        """The stack the client/server split cuts: the encoder's for an
        encoder-decoder, else the only one."""
        return "enc_layers" if self.is_encdec else "layers"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# the ssm_moe family's layer kinds, in ``layer_kinds`` and as the keys of
# each kind's mixer stack
LAYER_KINDS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class SSMMoEConfig(ModelConfig):
    """The ``ssm_moe`` family (Granite-4.0-H): a stack of Mamba-2 mixers
    and NoPE attention layers in a published order, each followed by a
    routed mixture of experts and a shared expert, with muP multipliers.
    The JAX package has no such family, so its fields live here and
    ``ModelConfig`` keeps the JAX package's fields alone.

    ``n_experts`` counts the experts held here, ``[expert_offset,
    expert_offset + n_experts)`` of the router's ``router_experts``: a
    card's share under expert parallelism."""
    layer_kinds: tuple = ()          # "mamba" | "attention", one a layer
    router_experts: int = 0          # the router's outputs (all experts)
    expert_offset: int = 0           # the first expert held here
    shared_expert_ff: int = 0        # the always-on SwiGLU's width
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # the score scale (0: 1/sqrt(hd))
    logits_scaling: float = 1.0      # both heads' logits are divided by it
    rms_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "grok_1_314b",
    "internvl2_2b",
    "qwen2_5_3b",
    "whisper_small",
    "mixtral_8x7b",
    "llama3_2_3b",
    "internlm2_1_8b",
    "mamba2_2_7b",
    "gemma_2b",
    "hymba_1_5b",
]

# The paper's own backbone (ViT-16 on CIFAR) — extra, not in the 10x4 matrix.
EXTRA_ARCH_IDS = ["vit16_cifar"]


def canonical_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.reduced()


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Return a reason string if (arch, shape) is skipped, else None."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.is_encdec:
        return ("enc-dec ASR decoder has no 500k autoregressive regime "
                "(cross-attn over fixed 1500-frame encoder output); "
                "see DESIGN.md shape/skip matrix")
    return None


def all_combos() -> Tuple[Tuple[str, str], ...]:
    return tuple((a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                 if skip_reason(a, s) is None)
