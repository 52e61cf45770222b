from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    dtype="bfloat16", remat=True, microbatches=4,
)  # [hf:Qwen/Qwen2.5-0.5B family] GQA kv=2, QKV bias

def reduced():
    return CONFIG.replace(
        name="qwen2.5-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        dtype="float32", remat=False)
