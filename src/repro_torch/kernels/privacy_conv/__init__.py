from repro_torch.kernels.privacy_conv.ops import privacy_conv
