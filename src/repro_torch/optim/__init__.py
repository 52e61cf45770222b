from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, fedadam, fedyogi, get_optimizer,
    map_moments, sgd, sgd_momentum)
