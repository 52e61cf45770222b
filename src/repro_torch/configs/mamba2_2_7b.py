from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128,
    ssm_expand=2, ssm_head_dim=64, norm="rmsnorm",
    dtype="bfloat16", remat=True, microbatches=4,
)  # [arXiv:2405.21060] SSD (state-space duality), attention-free

def reduced():
    return CONFIG.replace(
        name="mamba2-reduced", n_layers=2, d_model=128, vocab=512,
        ssm_state=16, ssm_head_dim=32, dtype="float32", remat=False)
