"""The card's idle share over the profiled rounds: 1 − (the union of the
device operations' intervals) / (the profiled stretch's wall), both from
one trace."""
LAYER = "card"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p.kernels:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
