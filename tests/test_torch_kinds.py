"""The port's remaining attention decoders held against the reference on the
same state: qwen2-vl (embeddings in, M-RoPE on text positions), the moe
kind's aux loss in ``loss_fn`` and through the remat checkpoint, the
decode grouping of a moe step, the five configs, ``swattn``'s plain
version at gemma3's head dim 256 against the reference's Pallas kernel in
interpret mode, and ``init_params``' block-wise draw of large leaves.
Parameters are the reference's, carried across with
``repro_torch.convert``; inputs are drawn with numpy.

Tolerances: float32 logits within rtol=atol=3e-4 and bfloat16 within
5e-2 (tests/test_torch_lm.py); losses relative 1e-5 and gradients
relative L2 1e-4 (tests/test_torch_train.py); ``swattn`` float32 3e-4,
bfloat16 3e-2 (tests/test_torch_swattn.py).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import SINGLE_POD
from repro.configs.base import get_model_config as r_get_model_config
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.kernels.swattn import swattn_pallas
from repro.models import registry as r_registry
from repro_torch.configs.base import (ARCH_IDS, SHAPES, RunConfig,
                                      get_model_config)
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference
from repro_torch.kernels.swattn import kernel as SW
from repro_torch.kernels.swattn import swattn_cuda
from repro_torch.models import module, moe, registry, transformer
from repro_torch.models.module import tree_leaves

from _torch_parity import (reference_bundle_params, to_jax,
                           to_torch)

NEW_ARCHS = ["mixtral_8x7b", "qwen3_moe_30b_a3b", "gemma3_4b",
             "qwen2_vl_7b", "codeqwen15_7b"]
TOL = {"float32": 3e-4, "bfloat16": 5e-2}
S, B = 32, 2


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_reference(arch):
    assert arch in ARCH_IDS
    mc, rmc = get_model_config(arch), r_get_model_config(arch)
    assert dataclasses.asdict(mc) == dataclasses.asdict(rmc)
    assert mc.param_count() == rmc.param_count()
    assert mc.active_param_count() == rmc.active_param_count()


def test_qwen3_moe_published_parameter_count():
    """The published qwen3-moe-30b-a3b: 623,120,640 parameters a layer
    (q, o 2 x 2048 x 4096; k, v 2 x 2048 x 512; the router 2048 x 128; the
    experts 3 x 128 x 2048 x 768; 4,352 of norm scales) and 30.53e9 in
    all, 61.1 GB in bf16."""
    mc = get_model_config("qwen3_moe_30b_a3b")
    specs = transformer.model_specs(mc)
    per_layer = sum(math.prod(s.shape) for p_, s in
                    module.tree_paths(specs).items()
                    if p_[0].startswith("stage_")) // mc.num_layers
    norms = 2 * mc.d_model + 2 * 128          # ln1, ln2; q_norm, k_norm
    assert per_layer == 623_120_640 and norms == 4_352
    n = module.count_params(specs)
    assert 30.5e9 < n < 30.6e9 and 61.0e9 < 2 * n < 61.2e9


@functools.lru_cache(maxsize=None)
def _ref(arch, **fields):
    """The reference's bundle (jitted train_forward and loss_fn) and
    params for tiny ``arch`` with ``fields`` replaced."""
    rmc = dataclasses.replace(r_tiny_of(arch), **fields)
    sh = dataclasses.replace(R_SHAPES["train_4k"], seq_len=S, global_batch=B)
    rb = r_registry.build(RRunConfig(model=rmc, shape=sh, mesh=SINGLE_POD))
    rparams = reference_bundle_params(rb, jax.random.key(21), jit=True)
    return rb, rparams


def _port(arch, **fields):
    mc = dataclasses.replace(tiny_of(arch), **fields)
    sh = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
    return registry.build(RunConfig(model=mc, shape=sh), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_qwen2_vl_embeddings_forward_matches_reference(use_kernel, dtype,
                                                       rng):
    """[B, S, D] float32 embeddings in, M-RoPE on text positions (three
    equal streams), the kernel gate on and off."""
    fields = {"use_pallas_attn": use_kernel, "dtype": dtype}
    rb, rparams = _ref("qwen2_vl_7b", **fields)
    b = _port("qwen2_vl_7b", **fields)
    emb = rng.standard_normal((B, S, b.cfg.model.d_model)).astype(np.float32)
    ref, raux = jax.jit(rb.train_forward)(rparams,
                                          {"inputs": jnp.asarray(emb)})
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    got, aux = b.train_forward(params, {"inputs": torch.from_numpy(emb)})
    assert got.dtype == getattr(torch, dtype)
    assert float(aux) == float(raux) == 0.0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_mrope_on_text_positions_equals_rope(rng):
    """Text positions make M-RoPE's three streams equal, so the forward
    equals the same model with standard RoPE, bit for bit."""
    b = _port("qwen2_vl_7b")
    params = b.init_params(torch.Generator().manual_seed(4))
    emb = torch.from_numpy(rng.standard_normal(
        (B, S, b.cfg.model.d_model)).astype(np.float32))
    got, _ = b.train_forward(params, {"inputs": emb})
    plain, _ = _port("qwen2_vl_7b", mrope_sections=()).train_forward(
        params, {"inputs": emb})
    assert torch.equal(got, plain)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_30b_a3b"])
def test_moe_aux_loss_in_loss_fn_matches_reference(arch):
    """loss_fn's total is loss + aux_weight · aux: at aux_weight 1 the aux
    loss's share of the gradients (the routers', and through the
    probabilities every layer below) is as large as the loss's."""
    from repro.data import make_train_batch as r_make_train_batch
    from repro_torch.data import make_train_batch
    rb, rparams = _ref(arch)
    rrc = RRunConfig(model=r_tiny_of(arch), shape=dataclasses.replace(
        R_SHAPES["train_4k"], seq_len=S, global_batch=B), mesh=SINGLE_POD)
    f = jax.jit(jax.value_and_grad(
        lambda p_, b_: rb.loss_fn(p_, b_, loss_chunk=16, aux_weight=1.0),
        has_aux=True))
    (rval, (raux, _)), rg = f(rparams, r_make_train_batch(rrc, 0))
    b = _port(arch)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    for x in tree_leaves(params):
        x.requires_grad_(True)
    val, (aux, _) = b.loss_fn(params, make_train_batch(b.cfg, 0, "cpu"),
                              loss_chunk=16, aux_weight=1.0)
    val.backward()
    assert float(aux) > 0.5
    np.testing.assert_allclose(float(val), float(rval), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    g = jax.tree.map(lambda t: t.grad.numpy(), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        ref = np.asarray(functools.reduce(lambda t, k: t[k.key], path, rg))
        rel = np.linalg.norm(leaf - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 1e-4, (path, rel)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_carries_the_moe_aux_loss(policy):
    """A checkpointed moe layer hands its aux loss out with its output:
    the gradients of loss + aux under a remat policy equal 'none''s."""
    from repro_torch.data import make_train_batch
    b = _port("qwen3_moe_30b_a3b")
    params = b.init_params(torch.Generator().manual_seed(6))
    batch = make_train_batch(b.cfg, 0, "cpu")
    grads = {}
    for pol in ("none", policy):
        for x in tree_leaves(params):
            x.grad = None
            x.requires_grad_(True)
        val, (aux, _) = b.loss_fn(params, batch, remat_policy=pol,
                                  aux_weight=1.0)
        val.backward()
        grads[pol] = [x.grad.clone() for x in tree_leaves(params)]
    router = [i for i, (p_, _) in enumerate(module.tree_paths(params).items())
              if p_[-1] == "router"]
    for a, r in zip(grads[policy], grads["none"]):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-7)
    assert router and all(float(grads["none"][i].abs().sum()) > 0
                          for i in router)


def test_moe_decode_routes_the_batch_as_one_group(monkeypatch):
    """Prefill routes each row as a group ([B, S, D]); a decode step the
    whole batch as one ([1, B, D]), as the reference does."""
    seen = []
    real = moe.moe_block

    def recording(x, *a, **kw):
        seen.append(tuple(x.shape))
        return real(x, *a, **kw)
    monkeypatch.setattr(moe, "moe_block", recording)
    b = _port("mixtral_8x7b")
    params = b.init_params(torch.Generator().manual_seed(8))
    toks = torch.randint(0, 256, (3, 10), generator=torch.Generator()
                         .manual_seed(1))
    last, caches = b.prefill(params, {"inputs": toks})
    L = b.cfg.model.num_layers
    assert seen == [(3, 10, 64)] * L
    b.decode_step(params, last.argmax(-1)[:, None], caches, 10)
    assert seen[L:] == [(1, 3, 64)] * L


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8, 20])
@pytest.mark.parametrize("S_", [16, 37])
def test_swattn_hd256_matches_pallas(S_, window, dtype, rng):
    """gemma3's head dim 256 (8/4 heads): the wrapper's plain version
    against the reference's Pallas kernel in interpret mode."""
    assert 256 in SW.HEAD_DIMS
    q = rng.standard_normal((2, S_, 8, 256)).astype(np.float32)
    k, v = (rng.standard_normal((2, S_, 4, 256)).astype(np.float32)
            for _ in range(2))
    got = swattn_cuda(*(to_torch(a, dtype) for a in (q, k, v)),
                      window=window)
    ref = swattn_pallas(*(to_jax(a, dtype) for a in (q, k, v)),
                        window=window, interpret=True)
    tol = {"float32": 3e-4, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -- init_params: large leaves drawn a block of rows at a time ---------------

def test_large_leaf_is_drawn_in_blocks_into_its_dtype(monkeypatch):
    """A leaf whose float32 draw passes ``WHOLE_DRAW_BYTES`` is drawn a
    block of rows at a time straight into the output dtype: the same
    values as drawing those blocks one after another and casting each."""
    spec = module.p((7, 5, 6), (None, None, None))
    monkeypatch.setattr(module, "WHOLE_DRAW_BYTES", 3 * 5 * 6 * 4)  # 3 rows
    got = module.init_leaf(spec, torch.Generator().manual_seed(2),
                           torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (7, 5, 6)
    g = torch.Generator().manual_seed(2)
    std = 1 / math.sqrt(7 * 5)
    want = torch.cat([(torch.randn((n, 5, 6), generator=g) * std)
                      .to(torch.bfloat16) for n in (3, 3, 1)])
    assert torch.equal(got, want)


def test_leaves_under_the_limit_keep_their_draw():
    """Every leaf of the models the earlier chip phases draw on the card
    is drawn whole, as before the block-wise draw: the values equal
    (randn · std).to(dtype)."""
    for arch in ("h2o_danube_1_8b", "hymba_1_5b"):
        largest = max(math.prod(s.shape) for s in module.tree_paths(
            transformer.model_specs(get_model_config(arch))).values())
        assert 4 * largest <= module.WHOLE_DRAW_BYTES, arch
    spec = module.p((4, 16, 8), ("layers", "embed", "mlp"))
    got = module.init_leaf(spec, torch.Generator().manual_seed(3),
                           torch.bfloat16)
    x = torch.randn((4, 16, 8), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, (x * (1 / math.sqrt(64))).to(torch.bfloat16))
