from repro_torch.serving.engine import QueryServer
from repro_torch.serving.runtime import Outcome, ServingRuntime
