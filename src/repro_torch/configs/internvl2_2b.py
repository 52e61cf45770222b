from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92553,
    n_patches=256, mlp="swiglu", norm="rmsnorm", dtype="bfloat16",
    remat=True,
)  # [arXiv:2404.16821] InternViT (stub) + InternLM2 backbone

def reduced():
    return CONFIG.replace(
        name="internvl2-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, n_patches=16,
        dtype="float32", remat=False)
