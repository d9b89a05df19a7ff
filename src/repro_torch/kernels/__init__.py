"""The port's hand-written kernels (CUDA C++ for Hopper)."""
