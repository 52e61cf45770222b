from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, mlp="swiglu", norm="rmsnorm",
    tie_embeddings=False, dtype="bfloat16", remat=True, microbatches=8,
)  # [hf:xai-org/grok-1] 8 experts top-2

def reduced():
    return CONFIG.replace(
        name="grok-1-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, n_experts=4,
        top_k=2, dtype="float32", remat=False)
