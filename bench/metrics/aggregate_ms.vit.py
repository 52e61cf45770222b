"""Time per round inside the strategy's ``aggregate`` call (Eqs. 6 and 8,
the ``aggregate`` kernel, the one host sync of the losses), the span
ending on a device synchronisation. Read over the traced run's window."""
LAYER = "strategy: federated/strategies/ssfl.py"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "aggregate"


def read(ctx):
    vals = [u["spans"].get(SPAN, 0.0) for u in ctx.units if u.get("spans")]
    return 1e3 * sum(vals) / len(vals) if vals else None
