from repro_torch.common.bridge import flatten, to_numpy, to_torch, unflatten
from repro_torch.common.device import resolve_device, seeded_generator
from repro_torch.common.tree import (
    tree_add,
    tree_bytes,
    tree_global_norm,
    tree_scale,
    tree_size,
    tree_zeros_like,
)
