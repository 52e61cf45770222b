"""The port's cost model on one H100 (``repro_torch.roofline.analysis``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW, active_params, bound, count_flops, mfu, model_flops, roofline_terms)
