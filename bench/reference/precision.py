"""Matrix products of the plain references, in fp32 or, for the
lower-precision control, with every operand rounded first.

``prec`` names the precision:

* ``"fp32"``: a plain fp32 product (TF32 switched off by the caller);
* ``"tf32"``: operands rounded to TF32's 10-bit mantissa (round to
  nearest even), products and sums in fp32, as the tensor cores compute
  a TF32 matmul: the control of an fp32 configuration;
* ``"fp8"``: operands scaled per tensor so that their largest magnitude
  is e4m3's largest finite value (448), rounded to ``float8_e4m3fn`` and
  scaled back, sums in fp32: the usual fp8 training recipe, the control
  of a bf16 configuration.

The rounding applies to the forward product and to both products of its
backward pass, where the cotangent is rounded too.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def quantize(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return x
    x = x.float()
    if prec == "tf32":
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0x0FFF + lsb) & ~0x1FFF
        return bits.view(torch.float32)
    if prec == "fp8":
        amax = x.abs().amax()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {prec!r}: expected fp32, tf32 or fp8")


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum the broadcast leading axes of ``g`` down to ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(a, b)
        return torch.matmul(quantize(a, prec), quantize(b, prec))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = lambda t: quantize(t, ctx.prec)
        gq = q(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _sum_to(torch.matmul(gq, q(b).transpose(-1, -2)), a.shape)
        if ctx.needs_input_grad[1]:
            gb = _sum_to(torch.matmul(q(a).transpose(-1, -2), gq), b.shape)
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32"):
    """``a @ b`` (``torch.matmul`` broadcasting) in ``prec``."""
    if prec == "fp32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, prec)
