from repro_torch.federated.strategies.base import (  # noqa: F401
    CohortResult, RoundContext, Strategy, available_strategies,
    get_strategy, register_strategy)
# importing the built-ins registers them
from repro_torch.federated.strategies import (  # noqa: F401
    async_buffered, fedavg, hasfl, splitfed, ssfl, unstable)
from repro_torch.federated.strategies.async_buffered import (  # noqa: F401
    BufferedAsync)
from repro_torch.federated.strategies.fedavg import (  # noqa: F401
    FedAdam, FedAvg, FedAvgM, FedYogi)
from repro_torch.federated.strategies.hasfl import HASFL  # noqa: F401
from repro_torch.federated.strategies.splitfed import (  # noqa: F401
    DynamicSplitFed, SplitFed)
from repro_torch.federated.strategies.ssfl import SuperSFL  # noqa: F401
from repro_torch.federated.strategies.unstable import (  # noqa: F401
    UnstableParticipation, staleness_weights)
