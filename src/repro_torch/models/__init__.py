"""The paper's split models in PyTorch: the CNNs (COVID-CT, MURA VGG19) and
the cholesterol MLP, with the JAX package's layouts (NHWC, HWIO, [in, out])."""
