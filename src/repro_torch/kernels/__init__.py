"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
PyTorch twins; ``ops`` dispatches on the tensor's device."""
