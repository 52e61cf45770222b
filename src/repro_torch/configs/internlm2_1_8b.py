from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92544,
    mlp="swiglu", norm="rmsnorm", dtype="bfloat16", remat=True, microbatches=2,
)  # [arXiv:2403.17297] GQA kv=8

def reduced():
    return CONFIG.replace(
        name="internlm2-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        dtype="float32", remat=False)
