"""Device ms a step of the Mamba-2 mixers (``models/ssm.py``), forward
and backward: the operations queued inside the program's span
``ssm.mix`` (every forward run, remat's recomputations included) or
inside its backward's stretches, from the ``ssm.mix.backward.begin``
point to the next ``ssm.mix.backward.end``
(``harness.span_time.region_device_s``). The backward's stretches may
hold a few operations of the layer's other branches that autograd runs
between the mixer's."""
from harness.span_time import per_unit_ms, region_device_s

LAYER = "models: models/"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return per_unit_ms(ctx, "ssm.mix", region_device_s)
