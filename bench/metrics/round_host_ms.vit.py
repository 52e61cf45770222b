"""The engine's own host time per round: the round's wall minus the time
inside the strategy spans (fleet draws, ``_account_cohort``'s per-client
loop, ``comm_cost``, the round record). Read over the traced run's
window, whose spans synchronise at their ends."""
LAYER = "engine: federated/engine.py"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(ctx):
    vals = [u["t1"] - u["t0"] - sum(u["spans"].values())
            for u in ctx.units if u.get("spans")]
    return 1e3 * sum(vals) / len(vals) if vals else None
