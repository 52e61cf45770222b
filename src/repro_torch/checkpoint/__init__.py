from repro_torch.checkpoint.ckpt import (  # noqa: F401
    FORMAT_VERSION, load_checkpoint, save_checkpoint)
