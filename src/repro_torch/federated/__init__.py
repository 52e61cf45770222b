from repro_torch.federated.engine import (  # noqa: F401
    Engine, EngineBuilder, predict, resolve_device)
from repro_torch.federated.round import FederatedTrainer  # noqa: F401
from repro_torch.federated.simulator import Fleet, make_fleet  # noqa: F401
from repro_torch.federated.state import (  # noqa: F401
    TrainState, init_train_state)
from repro_torch.federated.strategies import (  # noqa: F401
    Strategy, available_strategies, get_strategy, register_strategy)
from repro_torch.federated import metrics  # noqa: F401
