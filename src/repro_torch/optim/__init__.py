from repro_torch.optim.adam import AdamState, adamw
from repro_torch.optim.api import Optimizer, apply_updates
from repro_torch.optim.sgd import sgd
