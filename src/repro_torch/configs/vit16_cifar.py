from repro_torch.configs.base import ModelConfig

# The paper's own experimental backbone: ViT-16 adapted to CIFAR
# (patchified 32x32 images, classifier head).
CONFIG = ModelConfig(
    name="vit16-cifar", family="vit", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=0,
    n_classes=10, image_size=32, patch_size=4, mlp="gelu",
    norm="layernorm", dtype="float32",
)  # [arXiv:2010.11929] ViT-Base/16 geometry on CIFAR


def reduced():
    return CONFIG.replace(
        name="vit-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, n_classes=10,
        image_size=16, patch_size=4)
