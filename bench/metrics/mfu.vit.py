"""Model FLOPs of the traced run's rounds over (their window × the fp32
peak, 67 TFLOP/s; the configuration has TF32 off). The count is the
benchmark's own (``yardstick/flops.py``): per client and local step its
prefix, local head and, when it reached the server, the suffix, at its
depth and width; attention's score products left out."""
from yardstick import flops, hw

LAYER = "whole step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(ctx):
    if not ctx.units:
        return None
    c, t = ctx.config, ctx.traffic
    steps, batch = int(t["local_steps"]), int(t["batch_size"])
    total = sum(steps * flops.vit_client_step(c, d, w, batch, avail)
                for u in ctx.units for d, w, avail in u["clients"])
    return 100.0 * total / (ctx.window_s * hw.peak("float32"))
