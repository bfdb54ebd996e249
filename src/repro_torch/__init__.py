"""PyTorch/CUDA port of the split-learning system in ``repro``.

The package mirrors ``repro``'s layout (``repro/<sub>/<mod>.py`` becomes
``repro_torch/<sub>/<mod>.py``) and keeps its public names and tensor
layouts: NHWC activations, HWIO conv weights and ``[in, out]`` dense
weights, so states and checkpoints carry across. It imports ``torch`` and
``numpy`` only. Each Pallas kernel of ``repro`` on the ported path is a CUDA
kernel written for Hopper (``csrc/``), built at first use by
``repro_torch.kernels.build``; its plain PyTorch version runs only for
tensors on the CPU. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
