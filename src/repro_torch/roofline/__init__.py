"""The port's cost model on one H100 (``repro_torch.roofline.analysis``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    COLLECTIVE_WIRE_FACTOR, HW, CollectiveCounter, active_params, bound,
    collective_bytes, count_flops, mfu, model_flops, roofline_terms)
