"""Carry state across from the reference package.

``from_reference`` takes the reference's ``Filter2D`` as
``dataclasses.asdict(spec)`` (plain dicts and numbers, so the port never
imports the reference) plus its coefficients and gains as numpy, and
returns the port's spec, coefficient tensor and [N, 2] gains table.
``params_from_reference`` takes a model's parameter tree as numpy and
returns the port's, ``caches_from_reference`` the reference's decode
caches and ``opt_state_from_reference`` its AdamW state;
``params_to_numpy``, ``caches_to_numpy`` and ``opt_state_to_numpy`` hand
the port's back as numpy. Either way the two packages can be run on the
same state and their results compared.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec
from repro_torch.device import resolve_device
from repro_torch.models.module import tree_map
from repro_torch.optim.adamw import AdamWState


def from_reference(spec_fields: dict, coeffs, gains=None
                   ) -> Tuple[Filter2D, torch.Tensor, Optional[torch.Tensor]]:
    """The port's ``(Filter2D, coefficients, gains table)`` for a reference
    filter.

    ``spec_fields``: ``dataclasses.asdict`` of the reference ``Filter2D``
    (``border`` and ``requant`` nested as dicts). ``coeffs``: numpy
    ``[w, w]`` coefficients, an ``[N, w, w]`` bank, or for separable specs
    the ``(u, v)`` factors (or their ``[2, w]`` stack). ``gains``: None
    (the spec's own gains), a ``RequantSpec`` as a dict (or the port's
    ``RequantSpec``), a (multiplier, shift) pair or an ``[N, 2]`` table.
    The gains table is None when the spec carries no requant epilogue.
    """
    fields = dict(spec_fields)
    border = fields.get("border")
    if isinstance(border, dict):
        fields["border"] = BorderSpec(**border)
    rq = fields.get("requant")
    if isinstance(rq, dict):
        fields["requant"] = RequantSpec(**rq)
    known = {f.name for f in dataclasses.fields(Filter2D)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown Filter2D fields {sorted(unknown)}")
    spec = Filter2D(**fields)

    if spec.separable and isinstance(coeffs, (tuple, list)):
        co = torch.stack([torch.as_tensor(np.asarray(c)) for c in coeffs])
    else:
        co = torch.as_tensor(np.ascontiguousarray(coeffs))

    if spec.requant is None:
        if gains is not None:
            raise ValueError("gains given but the spec carries no requant")
        return spec, co, None
    n = spec.num_filters
    if gains is None:
        table = spec.requant.params(n)
    elif isinstance(gains, dict):
        table = RequantSpec(**gains).params(n)
    elif isinstance(gains, RequantSpec):
        table = gains.params(n)
    else:
        g = np.asarray(gains, np.int64)
        table = np.broadcast_to(g, (n, 2)) if g.shape == (2,) else g
    table = torch.as_tensor(np.asarray(table, np.int64)).to(torch.int32)
    if tuple(table.shape) != (n, 2):
        raise ValueError(f"gains table must be [{n}, 2]; got "
                         f"{tuple(table.shape)}")
    return spec, co, table.contiguous()


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: numpy has no bfloat16
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_reference(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The port's parameters for a reference parameter tree.

    ``tree``: nested dicts of numpy arrays as the reference's
    ``init_params`` returns them (``jax.tree.map(np.asarray, params)``):
    a whole LM (``embed``, ``stage_<i>`` with each leaf stacked over the
    stage's layers on axis 0, ``final_norm``, ``head``, ``meta_tokens``;
    xlstm's ``mlstm`` / ``slstm`` stages), whisper (``embed``,
    ``dec_pos``, ``encoder`` and ``decoder`` stacked over their layers,
    ``enc_ln``, ``dec_ln``) or one block's params (a mamba block's
    ``in_proj``, ``conv``, …). The
    port keeps the same names, layouts and dtypes, so the result is the
    same tree of tensors on ``device`` (the card unless the caller passes
    ``device='cpu'``).
    """
    return _tree_to_torch(tree, resolve_device(device))


def caches_from_reference(caches: List[Any], device="cuda") -> List[Any]:
    """The port's caches for the reference's (``prefill``'s output or
    ``tfm.cache_init``, as numpy): a list per stage of dicts — ``k``,
    ``v`` ([layers, B, L, KV, hd]), ``pos`` ([layers, L] int32), and
    ``k_scale`` / ``v_scale`` for int8 KV; nested ``{'attn', 'mamba'}``
    for hymba, the mamba state as ``conv`` and ``ssm`` (also the mamba
    kind's whole stage cache); xlstm's ``{conv, mlstm: (C, n, m)}`` and
    ``{conv, slstm: (c, n, h, m)}``, tuples kept; or whisper's
    ``{'self': stacked ring caches, 'cross': {k, v}}``. Same names,
    layouts and dtypes, on ``device`` (the card unless the caller passes
    ``device='cpu'``)."""
    return _tree_to_torch(caches, resolve_device(device))


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters as numpy, in the reference's tree. numpy has
    no bfloat16, so bfloat16 leaves come back as float32 (exact)."""
    return _tree_to_numpy(params)


def caches_to_numpy(caches: List[Any]) -> List[Any]:
    """The port's caches as numpy, in the reference's tree (bfloat16
    leaves as float32)."""
    return _tree_to_numpy(caches)


def opt_state_from_reference(state, device="cuda") -> AdamWState:
    """The port's AdamW state for the reference's ``AdamWState(step, m,
    v)`` as numpy (``jax.tree.map(np.asarray, state)``, or any triple in
    that order): the step a 0-d int32 tensor on the host, m and v trees
    on ``device`` (the card unless the caller passes ``device='cpu'``)."""
    step, m, v = state
    dev = resolve_device(device)
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32),
                      m=_tree_to_torch(m, dev), v=_tree_to_torch(v, dev))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's AdamW state as numpy: the step an int32 0-d array, m
    and v trees of arrays (the reference's ``AdamWState(*...)`` takes
    it)."""
    return AdamWState(step=np.asarray(int(state.step), np.int32),
                      m=_tree_to_numpy(state.m), v=_tree_to_numpy(state.v))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_to_numpy(tree):
    return tree_map(_to_numpy, tree)


def _tree_to_torch(tree, dev: torch.device):
    return tree_map(lambda a: _tensor(a).to(dev), tree)
