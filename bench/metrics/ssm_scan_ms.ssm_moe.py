"""Device ms a step of the chunked SSD scan and its D·x skip
(``models/ssm.py``), forward and backward: the operations queued inside
the program's span ``ssm.scan`` (every forward run, remat's
recomputations included) or inside its backward's stretches, from the
``ssm.scan.backward.begin`` point to the next ``ssm.scan.backward.end``
(``harness.span_time.region_device_s``)."""
from harness.span_time import per_unit_ms, region_device_s

LAYER = "models: models/"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(ctx):
    return per_unit_ms(ctx, "ssm.scan", region_device_s)
