from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, mlp="swiglu",
    norm="rmsnorm", dtype="bfloat16", remat=True, microbatches=2,
)  # [arXiv:2411.13676] parallel attention + mamba heads per layer

def reduced():
    return CONFIG.replace(
        name="hymba-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, ssm_state=8,
        ssm_head_dim=32, dtype="float32", remat=False)
