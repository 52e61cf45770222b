"""Model FLOPs of the traced run's steps over (their window × the bf16
peak, 989 TFLOP/s), counted by ``yardstick/flops_ssm_moe.py``: the TPGF
rule over the Mamba-2 projections, attention, the router, the shared
expert and the routed experts live on this card; the scan's and
attention's score products left out."""
from yardstick import flops_ssm_moe, hw

LAYER = "whole step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    # the count is this family's: another configuration has nothing here
    if not ctx.units or ctx.config.get("family") != "ssm_moe":
        return None
    total = sum(flops_ssm_moe.ssm_moe_tpgf_step(ctx.config, u["work"])
                for u in ctx.units)
    return 100.0 * total / (ctx.window_s * hw.peak("bfloat16"))
