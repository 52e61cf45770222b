"""Where the port's tensors go when a caller names no device: the card.

Every public constructor of the port (``Engine``, ``models.model.
init_params`` and ``init_local_head``, ``models.decode.init_cache``,
``federated.state.init_train_state``, ``bridge.to_model_params``,
``bridge.to_torch``, ``launch.mesh.make_fleet_mesh``) resolves
``device=None`` here, so none of them builds on the CPU
without being told to.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
