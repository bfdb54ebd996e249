"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``). Sources are under
``repro_torch/csrc``; ``build`` compiles them at first use."""
