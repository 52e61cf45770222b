from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=256000,
    mlp="geglu", norm="rmsnorm", dtype="bfloat16", remat=True, microbatches=2,
)  # [arXiv:2403.08295] GeGLU, head_dim=256, MQA

def reduced():
    return CONFIG.replace(
        name="gemma-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab=512,
        dtype="float32", remat=False)
