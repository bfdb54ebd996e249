from repro_torch.common.bridge import flatten, to_numpy, to_torch, unflatten
from repro_torch.common.device import resolve_device, seeded_generator
