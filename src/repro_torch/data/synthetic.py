"""Data pipeline: deterministic synthetic datasets + non-IID partitioning.

The port's own copy of the JAX package's ``data/synthetic.py``: the same
numpy draws in the same order, so a seed gives the same images, labels,
shards and batch indices on both sides. Each class has a fixed random
prototype image; samples are prototype + noise, so accuracy is
meaningful (chance = 1/n_classes). Dirichlet(alpha) partitioning follows
the paper (alpha = 0.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray   # [N, H, W, 3] float32
    labels: np.ndarray   # [N] int32
    n_classes: int

    def __len__(self):
        return len(self.labels)


def make_synthetic_images(n_samples: int, n_classes: int, image_size: int,
                          *, noise: float = 0.35, seed: int = 0,
                          proto_seed: int = None) -> SyntheticImageDataset:
    """``proto_seed`` fixes the class prototypes independently of the sample
    noise so train/test splits share one underlying distribution."""
    proto_rng = np.random.default_rng(seed if proto_seed is None else proto_seed)
    rng = np.random.default_rng(seed)
    protos = proto_rng.normal(0.0, 1.0, (n_classes, image_size, image_size, 3))
    labels = rng.integers(0, n_classes, n_samples)
    images = protos[labels] + rng.normal(0.0, noise,
                                         (n_samples, image_size, image_size, 3))
    return SyntheticImageDataset(images.astype(np.float32),
                                 labels.astype(np.int32), n_classes)


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        *, seed: int = 0, min_per_client: int = 2
                        ) -> List[np.ndarray]:
    """Paper §III-A: Dirichlet(alpha) class-skewed client shards.

    Returns a list of index arrays, one per client.
    """
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


@dataclasses.dataclass
class ClientData:
    images: np.ndarray
    labels: np.ndarray

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        """One host batch, drawn as ``DeviceData.sample_indices`` draws one
        (client, step): the same ``integers`` call."""
        idx = rng.integers(0, len(self.labels), batch_size)
        return {"images": self.images[idx], "label": self.labels[idx]}


class DeviceData:
    """Every client shard concatenated into ONE flat ``images``/``labels``
    tensor pair on ``device``, plus the per-client offsets that translate
    shard-local sample indices to flat ones. The pixels are uploaded once;
    each local step gathers its batch on the device by index.

    Batch-RNG contract: ``sample_indices`` draws from the caller's numpy
    stream in step-major, client-minor order (one ``integers`` call per
    (step, client)), exactly as the reference does, so a seed gives the
    same batches on both sides. Labels are int64, torch's index type.
    """

    def __init__(self, clients, device):
        sizes = np.array([len(c.labels) for c in clients], np.int64)
        self.sizes = sizes
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.images = torch.as_tensor(
            np.concatenate([c.images for c in clients], axis=0)).to(device)
        self.labels = torch.as_tensor(
            np.concatenate([c.labels for c in clients], axis=0)
            .astype(np.int64)).to(device)

    def sample_indices(self, ids, steps: int, batch_size: int,
                       rng: np.random.Generator) -> np.ndarray:
        """[steps, len(ids), batch_size] int32 flat-array indices."""
        out = np.empty((steps, len(ids), batch_size), np.int32)
        for s in range(steps):
            for j, i in enumerate(ids):
                out[s, j] = self.offsets[i] + rng.integers(
                    0, self.sizes[i], batch_size)
        return out


def as_device_data(data: Dict[str, object], device) -> DeviceData:
    """The (cached) device-resident view of a ``make_federated_data`` dict."""
    dd = data.get("_device")
    if dd is None or dd.device_key != str(device):
        dd = data["_device"] = DeviceData(data["clients"], device)
        dd.device_key = str(device)
    return dd


def make_federated_data(n_clients: int, *, n_classes: int = 10,
                        image_size: int = 16, samples: int = 4096,
                        alpha: float = 0.5, seed: int = 0,
                        noise: float = 0.35) -> Dict[str, object]:
    ds = make_synthetic_images(samples, n_classes, image_size, seed=seed,
                               noise=noise)
    shards = dirichlet_partition(ds.labels, n_clients, alpha, seed=seed + 1)
    clients = [ClientData(ds.images[s], ds.labels[s]) for s in shards]
    test = make_synthetic_images(max(512, samples // 8), n_classes,
                                 image_size, seed=seed + 2, proto_seed=seed,
                                 noise=noise)
    return {"clients": clients, "test": test, "dataset": ds}


def synthetic_lm_batches(vocab: int, seq_len: int, batch: int, steps: int,
                         *, seed: int = 0):
    """Markov-chain token stream (learnable LM data; the serving path's
    prompts). The reference's numpy draws, in the same order."""
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
