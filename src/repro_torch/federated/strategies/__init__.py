from repro_torch.federated.strategies.base import (  # noqa: F401
    CohortResult, RoundContext, Strategy, available_strategies,
    get_strategy, register_strategy)
# importing the built-ins registers them
from repro_torch.federated.strategies import ssfl  # noqa: F401
