"""Hand-written Hopper kernels (``csrc/``) behind autograd wrappers, each beside its plain PyTorch version."""
