"""Bytes and operations the port's hand-written kernels must do, from
shapes alone: each input read once, each output written once.

Frozen copies of ``fuse_work``, ``aggregate_work`` and ``tier_sum_work``
in ``src/repro_torch/roofline/analysis.py`` at commit
c407b0fb230f1fbd6f630de9d44e64d45a4e7d44. Each returns
``(bytes, operations)``.
"""
from __future__ import annotations

from typing import Tuple


def fuse_work(n: int, itemsize: int = 4) -> Tuple[float, float]:
    """TPGF Eq. 4 over ``n`` elements: a and b read, the output written;
    w·a + (1 − w)·b with the clip scale, 4 operations each."""
    return 3.0 * itemsize * n, 4.0 * n


def aggregate_work(n_clients: int, n_layers: int, feat: int
                   ) -> Tuple[float, float]:
    """Eq. 8, fp32: the client stack [N, L, F] and the weights [N, L]
    read, the server rows [L, F] read and written; a multiply-add per
    client element and three operations per output."""
    N, L, F = n_clients, n_layers, feat
    return (4.0 * N * L * F + 8.0 * L * F + 4.0 * N * L,
            2.0 * N * L * F + 3.0 * L * F)


def tier_sum_work(n_tiers: int, n: int) -> Tuple[float, float]:
    """The weighted tier sum, fp32: T leaves of ``n`` read, one written;
    T products and T − 1 sums per element."""
    return 4.0 * (n_tiers + 1) * n, (2.0 * n_tiers - 1) * n
