"""Model FLOPs of the traced run's steps over (their window × the bf16
peak, 989 TFLOP/s). The count is the benchmark's own
(``yardstick/flops.py``): per token the client prefix three times over
(one forward, two backward), the local head and the server suffix with
its head, the top-k of the experts live; attention's score products left
out."""
from yardstick import flops, hw

LAYER = "whole step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    if not ctx.units:
        return None
    total = sum(flops.lm_tpgf_step(ctx.config, u["work"]) for u in ctx.units)
    return 100.0 * total / (ctx.window_s * hw.peak("bfloat16"))
