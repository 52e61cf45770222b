"""FL005 corpus for the port: conforming Strategy implementations pass.
Parsed, never run."""


@register_strategy("corpus-good")  # noqa: F821 — corpus, parsed only
class ConformingStrategy:
    def init_round(self, engine, ctx):
        pass

    def cohort_step(self, engine, ctx, ws, d, ids):
        pass

    def comm_cost(self, engine, d, available, ids=None):
        return 0.0

    def slot_outputs(self, engine, ws, ids, res):
        return {"losses": res.losses}


class ConformingChild(ConformingStrategy):
    def comm_cost(self, engine, d, available):    # the 3-arg form
        return 0.0

    def prepare_fleet(self, cfg, fleet, device_model=None):
        return fleet
