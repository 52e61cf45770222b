"""FL004 corpus for the port: nondeterminism on the round path, torch's
global stream included. Parsed, never run."""
# fleetlint: scope=fleet
import time

import numpy as np
import torch


def drifting_round(x, n):
    stamp = time.perf_counter()              # FL004: wall clock
    jitter = np.random.randn(3)              # FL004: global numpy stream
    rng = np.random.default_rng()            # FL004: unseeded
    torch.manual_seed(0)                     # FL004: reseeds the global stream
    a = torch.rand(3)                        # FL004: global torch stream
    b = torch.randn(n, device=x.device)      # FL004: global torch stream
    c = torch.randint(0, 10, (n,))           # FL004: global torch stream
    d = torch.randperm(n)                    # FL004: global torch stream
    e = torch.normal(0.0, 1.0, size=(n,))    # FL004: global torch stream
    f = torch.randn_like(x)                  # FL004: global torch stream
    x.uniform_(-1.0, 1.0)                    # FL004: in-place, global
    x.normal_()                              # FL004: in-place, global
    torch.empty(n).bernoulli_(0.5)           # FL004: in-place, global
    return stamp, jitter, rng, a, b, c, d, e, f
