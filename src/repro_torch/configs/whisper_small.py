from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=51865,
    n_enc_layers=12, enc_frames=1500, mlp="gelu", norm="layernorm",
    tie_embeddings=True, dtype="bfloat16", remat=True, microbatches=1,
)  # [arXiv:2212.04356] enc-dec; conv/mel frontend is a stub

def reduced():
    return CONFIG.replace(
        name="whisper-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        n_enc_layers=2, enc_frames=16, dtype="float32", remat=False)
