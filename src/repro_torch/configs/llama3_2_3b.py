from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=128256,
    mlp="swiglu", norm="rmsnorm", rope_theta=500000.0,
    dtype="bfloat16", remat=True, microbatches=4,
)  # [hf:meta-llama/Llama-3.2 family] small llama3, tied embeddings

def reduced():
    return CONFIG.replace(
        name="llama3.2-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        dtype="float32", remat=False)
