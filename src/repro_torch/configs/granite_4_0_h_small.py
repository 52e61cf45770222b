from repro_torch.configs.base import SSMMoEConfig

# ibm-granite/granite-4.0-h-small config.json: layer_types
_KINDS = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = SSMMoEConfig(
    name="granite-4.0-h-small", family="ssm_moe", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=768, vocab=100352,
    mlp="swiglu", norm="rmsnorm", tie_embeddings=False, n_experts=72,
    top_k=10, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_dim=4,
    layer_kinds=_KINDS, router_experts=72, expert_offset=0,
    shared_expert_ff=1536, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=0.0078125,
    logits_scaling=16.0, rms_norm_eps=1e-5, dtype="bfloat16", remat=True,
    use_pallas=False, microbatches=4,
)  # 36 Mamba-2 + 4 NoPE GQA layers, 72 experts top-10 + a shared expert;
# the port's heads are untied (SuperSFL: embedding on the client, head on
# the server), the source ties them


def reduced():
    """Both layer kinds, a router wider than the experts held here (3 of
    8, from the third), and a shared expert."""
    return CONFIG.replace(
        name="granite-reduced", n_layers=4,
        layer_kinds=("mamba", "mamba", "attention", "mamba"), d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=512,
        n_experts=3, router_experts=8, expert_offset=2, top_k=3,
        shared_expert_ff=48, ssm_state=16, ssm_head_dim=16,
        attention_multiplier=0.125, dtype="float32", remat=False,
        microbatches=1)
