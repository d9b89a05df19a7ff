"""Port vs reference: the abstract twins, on ``meta`` tensors where the
reference has ``jax.ShapeDtypeStruct``s. For every tiny arch:
``cache_abstract``, ``cache_axes``, ``input_specs`` (train, prefill,
decode), ``abstract_params`` / ``param_bytes``, ``adamw_abstract`` and
``opt_state_axes``; and the per-module twins (``attention.cache_abstract``
/ ``cache_axes``, ``ssm.mamba_state_abstract``,
``xlstm.mlstm_state_abstract`` / ``slstm_state_abstract``,
``whisper.xkv_abstract``, ``transformer.cache_logical_axes``). The
reference's run in-process: none of them needs a device.

Tolerances: none. The trees (dict keys, list and tuple lengths, tuple
kinds), every shape, dtype and axes tuple equal; no port leaf has
storage.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import SINGLE_POD
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.models import attention as r_attention
from repro.models import module as r_module
from repro.models import registry as r_registry
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tfm
from repro.models import whisper as r_whisper
from repro.models import xlstm as r_xlstm
from repro.optim.adamw import adamw_abstract as r_adamw_abstract
from repro.optim.adamw import opt_state_axes as r_opt_state_axes
from repro_torch.configs.base import ARCH_IDS, SHAPES, RunConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.models import attention, module, registry, ssm, transformer
from repro_torch.models import whisper, xlstm
from repro_torch.optim.adamw import adamw_abstract, opt_state_axes

B, S = 2, 64


def _rcs(arch):
    rc = RunConfig(model=tiny_of(arch),
                   shape=dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                             global_batch=8))
    rrc = RRunConfig(model=r_tiny_of(arch),
                     shape=dataclasses.replace(R_SHAPES["train_4k"],
                                               seq_len=32, global_batch=8),
                     mesh=SINGLE_POD)
    return rc, rrc


def _dtype(x) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def assert_same_tree(got, want, where="root"):
    """Same structure; meta tensors against ShapeDtypeStructs by shape and
    dtype, anything else (axes tuples, None) equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, jax.ShapeDtypeStruct):
        assert torch.is_tensor(got) and got.device.type == "meta", where
        assert tuple(got.shape) == tuple(want.shape), where
        assert _dtype(got) == _dtype(want), (where, got.dtype, want.dtype)
    elif isinstance(want, (list, tuple)) and not (
            isinstance(want, tuple)
            and all(e is None or isinstance(e, str) for e in want)):
        assert type(got) is type(want) or (
            hasattr(want, "_fields") and tuple(type(got)._fields)
            == tuple(type(want)._fields)), (where, type(got), type(want))
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{where}/{i}")
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bundle_abstracts_equal_the_references(arch):
    rc, rrc = _rcs(arch)
    b = registry.build(rc, device="cpu")
    rb = r_registry.build(rrc)
    assert_same_tree(b.cache_abstract(B, S), rb.cache_abstract(B, S))
    assert_same_tree(b.cache_axes(), rb.cache_axes())
    for kind in ("train", "prefill", "decode"):
        assert_same_tree(b.input_specs(kind), rb.input_specs(kind))
    with pytest.raises(ValueError):
        b.input_specs("score")
    # the abstract cache is the concrete one on meta
    concrete = b.cache_init(B, S)
    assert [tuple(t.shape) for t in module.tree_leaves(concrete)] == [
        tuple(t.shape) for t in module.tree_leaves(b.cache_abstract(B, S))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_optimiser_abstracts_equal_the_references(arch):
    rc, rrc = _rcs(arch)
    specs = registry.build(rc, device="cpu").specs
    rspecs = r_registry.build(rrc).specs
    for dt, rdt in ((None, None), (torch.bfloat16, jax.numpy.bfloat16)):
        assert_same_tree(module.abstract_params(specs, dt),
                         r_module.abstract_params(rspecs, rdt))
    assert module.param_bytes(specs) == r_module.param_bytes(rspecs)
    assert module.param_bytes(specs, 2) == r_module.param_bytes(rspecs, 2)
    assert_same_tree(adamw_abstract(specs), r_adamw_abstract(rspecs))
    assert_same_tree(opt_state_axes(specs), r_opt_state_axes(rspecs))
    assert all(t.device.type == "meta"
               for t in module.tree_leaves(adamw_abstract(specs)))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if tiny_of(a).family != "encdec"])
def test_cache_logical_axes_equal_the_references(arch):
    """(whisper's cache axes are its bundle's, above)"""
    assert_same_tree(transformer.cache_logical_axes(tiny_of(arch)),
                     r_tfm.cache_logical_axes(r_tiny_of(arch)))


def test_module_abstracts_equal_the_references():
    for dt, rdt in ((torch.bfloat16, jax.numpy.bfloat16),
                    (torch.int8, jax.numpy.int8),
                    (torch.float32, jax.numpy.float32)):
        assert_same_tree(attention.cache_abstract(B, S, 2, 16, dt),
                         r_attention.cache_abstract(B, S, 2, 16, rdt))
    for q in (False, True):
        assert_same_tree(attention.cache_axes(q), r_attention.cache_axes(q))
    hy, xl, wh = (tiny_of("hymba_1_5b"), tiny_of("xlstm_350m"),
                  tiny_of("whisper_large_v3"))
    assert_same_tree(ssm.mamba_state_abstract(hy, B),
                     r_ssm.mamba_state_abstract(r_tiny_of("hymba_1_5b"), B))
    rxl = r_tiny_of("xlstm_350m")
    assert_same_tree(xlstm.mlstm_state_abstract(xl, B),
                     r_xlstm.mlstm_state_abstract(rxl, B))
    assert_same_tree(xlstm.slstm_state_abstract(xl, B),
                     r_xlstm.slstm_state_abstract(rxl, B))
    rwh = r_tiny_of("whisper_large_v3")
    assert_same_tree(whisper.xkv_abstract(wh, B, S),
                     r_whisper.xkv_abstract(rwh, B, S))
    assert_same_tree(whisper.self_cache_init(wh, B, device="meta"),
                     r_whisper.self_cache_init(rwh, B, abstract=True))
    assert_same_tree(transformer.cache_init(hy, B, S, device="meta"),
                     r_tfm.cache_init(r_tiny_of("hymba_1_5b"), B, S,
                                      abstract=True))
