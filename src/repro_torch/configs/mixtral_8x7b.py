from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, sliding_window=4096, mlp="swiglu",
    norm="rmsnorm", tie_embeddings=False, dtype="bfloat16", remat=True, microbatches=4,
)  # [arXiv:2401.04088] 8 experts top-2, sliding-window attention

def reduced():
    return CONFIG.replace(
        name="mixtral-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, n_experts=4,
        top_k=2, sliding_window=16, dtype="float32", remat=False)
