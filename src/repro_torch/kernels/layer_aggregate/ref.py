"""Plain PyTorch version of the Eq. 8 aggregation kernel.

    out[l, f] = (sum_n ww[n, l] * c[n, l, f] + lam * s[l, f])
                / (sum_n ww[n, l] + lam)

ww already folds the presence mask: ww[n, l] = w_n * (l < d_n).

The numerator mode (``numerator``) stops before the division:

    num[l, f] = sum_n ww[n, l] * c[n, l, f]          (fp32)

so that ranks that each hold some clients' rows can sum their numerators
before one division.
"""
from __future__ import annotations

import torch


def aggregate(c, ww, s, lam):
    """c [N, L, F]; ww [N, L]; s [L, F] -> [L, F] in s's dtype."""
    num = torch.einsum("nl,nlf->lf", ww.float(), c.float())
    den = ww.sum(dim=0).float()[:, None]
    out = (num + lam * s.float()) / (den + lam)
    return out.to(s.dtype)


def numerator(c, ww):
    """c [N, L, F]; ww [N, L] -> [L, F] fp32: Eq. 8's numerator."""
    return torch.einsum("nl,nlf->lf", ww.float(), c.float())
