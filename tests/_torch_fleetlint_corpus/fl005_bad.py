"""FL005 corpus for the port: Strategy hook signature drift, the
sanitizer's ``slot_outputs`` included. Parsed, never run."""


@register_strategy("corpus-bad")  # noqa: F821 — corpus, parsed only
class DriftingStrategy:
    def cohort_step(self, engine, ctx, ws, d, ids, steps):   # FL005: steps
        pass

    def comm_cost(self, engine, d, available, ids):   # FL005: ids no default
        return 0.0

    def slot_outputs(self, engine, ws, ids):      # FL005: missing res
        return {}


class DriftingChild(DriftingStrategy):
    def init_round(self, engine):                 # FL005: missing ctx
        pass
