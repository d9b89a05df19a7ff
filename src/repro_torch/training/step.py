"""train_step factory: gradient accumulation, clipping, schedule, AdamW,
as in the reference's ``training/step.py``.

The reference's step is a pure function for ``jax.jit``; the port's
works in place: the parameters and the optimiser state are updated where
they lie and returned. Gradients accumulate in each parameter's
``.grad``: one ``backward`` per microbatch, the sum then scaled by 1/n —
the reference's order (it sums the microbatch gradients into a float32
tree, then scales), without its extra float32 gradient tree. What
differs is inside one backward (the library's reduction orders, and the
embedding's scattered add, which on the card accumulates by atomics):
float32 gradients agree with the reference's to relative L2 1e-4 after
three steps (tests/test_torch_train.py). The step on a mesh (the
reference's ``shd``) is ``training/spmd.py``: each data-parallel rank
runs this body (``loss_fn``, one backward a microbatch) on gathered
weights.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_warmup


def make_grad_fn(bundle, rc: RunConfig) -> Callable:
    """``grad_fn(params, batch) -> (loss, aux)``: the mean loss and aux
    loss over the microbatches of ``batch`` (``rc.train.microbatch`` rows
    each; 0 takes the batch whole), their mean gradients left in each
    parameter's ``.grad`` (float32, like the parameters; zeros for a
    parameter the loss does not read). The parameters need a gradient
    only inside the call."""
    tc = rc.train

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        B = next(iter(batch.values())).shape[0]
        mb = tc.microbatch or B
        if B % mb:
            raise ValueError(f"batch {B} does not divide into microbatches "
                             f"of {mb}")
        n = B // mb
        loss_sum = aux_sum = 0.0
        for p_ in leaves:
            p_.grad = None
            p_.requires_grad_(True)
        try:
            for i in range(n):
                mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, (aux, _) = bundle.loss_fn(
                    params, mbatch, remat_policy=tc.remat_policy,
                    loss_chunk=tc.loss_chunk, z_loss=tc.z_loss)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
                aux_sum = aux_sum + aux.detach()
        finally:
            for p_ in leaves:
                p_.requires_grad_(False)
        for p_ in leaves:
            if p_.grad is None:
                # a leaf the loss does not read (the embedding table of an
                # embeddings-in config): a zero gradient, as jax.grad gives
                p_.grad = torch.zeros_like(p_)
        if n > 1:
            torch._foreach_mul_([p_.grad for p_ in leaves], 1.0 / n)
            return loss_sum * (1.0 / n), aux_sum * (1.0 / n)
        return loss_sum, aux_sum

    return grad_fn


def make_train_step(bundle, rc: RunConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, in place. The metrics: ``loss``, ``aux_loss`` and
    ``grad_norm`` (the norm before clipping) as 0-d tensors on the
    device, ``lr`` (float) and ``step`` (int, the step just taken). The
    clipped gradients stay in each parameter's ``.grad`` until the next
    step."""
    tc = rc.train
    grad_fn = make_grad_fn(bundle, rc)

    def train_step(params, opt_state, batch):
        loss, aux = grad_fn(params, batch)
        grads = [p_.grad for p_ in tree_leaves(params)]
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        lr = cosine_warmup(int(opt_state.step) + 1, peak_lr=tc.learning_rate,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.total_steps)
        params, opt_state = adamw_update(
            params, grads, opt_state, lr=lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
            weight_decay=tc.weight_decay)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": lr, "step": int(opt_state.step)}
        return params, opt_state, metrics

    return train_step
