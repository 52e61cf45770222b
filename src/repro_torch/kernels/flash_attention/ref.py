"""Plain PyTorch version of the flash-attention kernel: plain attention
with causal / sliding-window masks and GQA, as the reference's oracle."""
from __future__ import annotations

import torch

from repro_torch.models.layers import attention, make_attn_mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,hd]; k,v [B,Skv,K,hd] -> [B,Sq,H,hd]."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    pos_q = torch.arange(Sq, device=q.device).expand(B, Sq)
    pos_k = torch.arange(Skv, device=q.device).expand(B, Skv)
    mask = make_attn_mask(pos_q, pos_k, causal=causal, window=window)
    return attention(q, k, v, mask=mask)
