"""The benchmark's input generators: CIFAR-shaped images split over a
fleet, and Markov-chain token batches. Every traffic file names its
parameters; these functions read nothing else, and the same seed gives
the same inputs on the same kind of device.

Copied from ``src/repro_torch/data/synthetic.py`` at commit
c407b0fb230f1fbd6f630de9d44e64d45a4e7d44:

* ``class_images`` is ``make_synthetic_images`` (a fixed random prototype
  per class, each sample its class's prototype plus Gaussian noise),
  drawn on the card from a ``torch.Generator`` in two calls instead of
  with numpy on the host: 50,000 images are 154 M normal draws, seconds
  on the host and milliseconds on the card.
* ``dirichlet_partition`` is unchanged (numpy, the paper's class-skewed
  Dirichlet(alpha) shards, starved clients topped up).
* ``markov_lm_batches`` is ``synthetic_lm_batches`` unchanged (numpy).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def class_images(n_samples: int, n_classes: int, image_size: int, *,
                 noise: float, seed: int, device):
    """(images [N, H, W, 3] fp32, labels [N] int64), both on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (image_size, image_size, 3)
    protos = torch.randn((n_classes,) + shape, generator=gen, device=device)
    labels = torch.randint(0, n_classes, (n_samples,), generator=gen,
                           device=device)
    images = torch.randn((n_samples,) + shape, generator=gen, device=device)
    images.mul_(noise).add_(protos[labels])
    return images, labels


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        *, seed: int, min_per_client: int = 2
                        ) -> List[np.ndarray]:
    """Dirichlet(alpha) class-skewed client shards: one sorted index array
    per client."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    shards: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            shards[i].extend(part.tolist())
    out = []
    all_idx = np.arange(len(labels))
    for s in shards:
        if len(s) < min_per_client:  # top up starved clients
            extra = rng.choice(all_idx, min_per_client - len(s))
            s = list(s) + extra.tolist()
        out.append(np.array(sorted(s), dtype=np.int64))
    return out


def markov_lm_batches(vocab: int, seq_len: int, batch: int, steps: int,
                      *, seed: int):
    """``steps`` batches of Markov-chain tokens, each ``{"tokens",
    "labels"}`` [batch, seq_len] int32 (labels: the next token)."""
    rng = np.random.default_rng(seed)
    # sparse transition structure so a model can reduce loss below ln(V)
    trans = rng.integers(0, vocab, (vocab, 4))
    for _ in range(steps):
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, vocab, batch)
        choices = rng.integers(0, 4, (batch, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = trans[toks[:, t], choices[:, t]]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
