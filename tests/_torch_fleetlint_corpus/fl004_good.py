"""FL004 corpus for the port: explicit seeded streams pass. Parsed, never
run."""
# fleetlint: scope=fleet
import numpy as np
import torch


def seeded_round(seed, state, x, n):
    rng = np.random.default_rng(seed + 13)      # seeded, offset stream
    gen = torch.Generator().manual_seed(seed)   # the engine's own stream
    a = torch.rand(3, generator=gen)
    b = torch.randn(n, generator=gen, device=x.device)
    c = torch.randint(0, 10, (n,), generator=gen)
    d = torch.randperm(n, generator=gen)
    e = torch.normal(0.0, 1.0, size=(n,), generator=gen)
    x.uniform_(-1.0, 1.0, generator=gen)
    x.normal_(generator=gen)
    mask = torch.empty(n).bernoulli_(0.5, generator=gen)
    schedule = state["round_idx"] * 2           # time from round counter
    return rng.random(), a, b, c, d, e, mask, schedule
