from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, clip_by_global_norm, sgd
from repro_torch.optim.schedule import constant_schedule, cosine_schedule, linear_warmup_cosine
