"""The port's hand-written kernels (CUDA C++ for Hopper)."""
import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through ``kernel``:
    the port's kernels have no backward, as the reference's Pallas
    kernels have none (``jax.grad`` through them fails). The plain path
    is not taken instead, on either device."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel, and neither has the "
            "reference's Pallas kernel: train through the plain path "
            "(use_pallas_attn=False, use_pallas_conv=False), as the "
            "reference does")
