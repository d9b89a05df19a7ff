"""The port's LM forward and mamba block held against the reference's on
the same parameters and inputs: the reference's ``init_params`` output,
carried across by ``repro_torch.convert.params_from_reference``, and
tokens drawn with numpy. The port runs on the CPU, where the attention
kernel's wrapper runs its plain version; the reference runs its Pallas
kernels in interpret mode where ``use_pallas_attn`` / ``use_pallas_conv``
ask for them.

Tolerances: float32 within rtol=atol=3e-4 (the reference's own
kernel-vs-plain model tolerance, tests/test_pallas_in_model.py). bfloat16
logits within rtol=atol=5e-2: both packages round every layer's
activations to bfloat16, in different places (XLA keeps float32 inside
its fusions), and over 4 layers the logits (|logit| < 8, where one
bfloat16 step is 2^-5) drift by one or two steps. The moe kind's aux
loss within relative 1e-5 (float32) and 1e-3 (bfloat16).
"""
import dataclasses

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
from repro.models import module as r_module
from repro.models import registry as r_registry
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tfm
from repro_torch.configs.base import SHAPES, RunConfig, get_model_config
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference
from repro_torch.kernels.dwconv1d import kernel as DW
from repro_torch.kernels.swattn import kernel as SW
from repro_torch.models import module, registry, ssm, transformer

# the dense and moe decoders (token inputs, no meta tokens); qwen2-vl takes
# embeddings (tests/test_torch_kinds.py)
NEW_ARCHS = ["mixtral_8x7b", "qwen3_moe_30b_a3b", "gemma3_4b",
             "codeqwen15_7b"]
LM_ARCHS = ["h2o_danube_1_8b", "yi_6b"] + NEW_ARCHS
ARCHS = LM_ARCHS + ["hymba_1_5b", "qwen2_vl_7b"]
TOL = {"float32": 3e-4, "bfloat16": 5e-2}
# the moe aux loss, relative: float32 1e-5 (the routers' float32 softmaxes
# over the same hidden states); bfloat16 1e-3, the router reading hidden
# states that the two packages round to bfloat16 in different places (a
# CPU run reads up to 6e-5)
AUX_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _forwards(mc_fields: dict, arch: str, rng, S: int = 64):
    """(port logits, reference logits) as float32 numpy for the tiny
    config of ``arch`` with ``mc_fields`` replaced; the two aux losses
    agree (0 in both for the kinds without one)."""
    rmc = dataclasses.replace(r_tiny_of(arch), **mc_fields)
    sh = dataclasses.replace(R_SHAPES["train_4k"], seq_len=S, global_batch=2)
    rb = r_registry.build(RRunConfig(model=rmc, shape=sh, mesh=SINGLE_POD))
    rparams = rb.init_params(jax.random.key(7))
    toks = rng.integers(0, 255, (2, S)).astype(np.int32)
    ref, raux = rb.train_forward(rparams, {"inputs": jnp.asarray(toks)})
    mc = dataclasses.replace(tiny_of(arch), **mc_fields)
    b = registry.build(RunConfig(model=mc, shape=SHAPES["train_4k"]),
                       device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    got, aux = b.train_forward(params, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == transformer.model_dtype(mc)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(raux),
                               rtol=AUX_TOL[mc.dtype])
    assert (float(aux) == 0.0) == (mc.family != "moe")
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_forward_matches_reference(arch, use_kernel, dtype, rng):
    before = SW.swattn.launches
    got, ref = _forwards({"use_pallas_attn": use_kernel, "dtype": dtype},
                         arch, rng)
    assert SW.swattn.launches == before            # CPU: plain version
    assert got.shape == ref.shape == (2, 64, 256)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_meta_tokens_are_sinks(use_kernel, rng):
    """Meta tokens (sinks) turn the kernel gate off in both packages;
    the forward still matches, ragged S included."""
    got, ref = _forwards({"use_pallas_attn": use_kernel,
                          "num_meta_tokens": 4}, "h2o_danube_1_8b", rng,
                         S=37)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def test_kernel_and_plain_attention_agree_in_the_port(rng):
    """The port's own two attention paths, as the reference's
    tests/test_pallas_in_model.py holds its own."""
    mc = tiny_of("h2o_danube_1_8b")
    toks = torch.from_numpy(rng.integers(0, 255, (2, 40)))
    outs = []
    for flag in (False, True):
        b = registry.build(RunConfig(
            model=dataclasses.replace(mc, use_pallas_attn=flag),
            shape=SHAPES["train_4k"]), device="cpu")
        params = b.init_params(torch.Generator().manual_seed(3))
        outs.append(b.train_forward(params, {"inputs": toks})[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_stages_equal_reference(arch, tiny):
    rmc = r_tiny_of(arch) if tiny else r_get_model_config(arch)
    mc = tiny_of(arch) if tiny else get_model_config(arch)
    assert [dataclasses.astuple(s) for s in transformer.make_stages(mc)] == \
        [dataclasses.astuple(s) for s in r_tfm.make_stages(rmc)]
    assert mc.param_count() == rmc.param_count()
    assert mc.active_param_count() == rmc.active_param_count()
    assert dataclasses.asdict(mc) == dataclasses.asdict(rmc)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_tree_equals_reference(arch, tiny):
    rmc = r_tiny_of(arch) if tiny else r_get_model_config(arch)
    mc = tiny_of(arch) if tiny else get_model_config(arch)
    rspecs = r_module.tree_paths(r_tfm.model_specs(rmc))
    specs = module.tree_paths(transformer.model_specs(mc))
    assert sorted(specs) == sorted(rspecs)
    for path, s in specs.items():
        r = rspecs[path]
        assert (s.shape, s.axes, s.init, s.scale) == \
            (r.shape, r.axes, r.init, r.scale), path
    assert module.count_params(transformer.model_specs(mc)) == \
        r_module.count_params(r_tfm.model_specs(rmc))


def test_init_params_is_seeded_and_follows_the_specs():
    mc = tiny_of("yi_6b")
    b = registry.build(RunConfig(model=mc, shape=SHAPES["train_4k"]),
                       device="cpu")
    p1 = module.tree_paths(b.init_params(torch.Generator().manual_seed(5)))
    p2 = module.tree_paths(b.init_params(torch.Generator().manual_seed(5)))
    specs = module.tree_paths(b.specs)
    assert sorted(p1) == sorted(specs)
    for path, spec in specs.items():
        assert tuple(p1[path].shape) == spec.shape, path
        assert p1[path].dtype == torch.float32
        assert torch.equal(p1[path], p2[path]), path
    assert torch.all(p1[("final_norm", "scale")] == 1)
    wq = p1[("stage_0", "attn", "wq")]       # lecun over the leading dims,
    fan_in = mc.num_layers * mc.d_model * mc.num_heads  # layers included
    assert abs(float(wq.std()) * fan_in ** 0.5 - 1.0) < 0.1
    bf = module.tree_paths(b.init_params(torch.Generator().manual_seed(5),
                                         dtype=torch.bfloat16))
    assert bf[("embed", "table")].dtype == torch.bfloat16


def test_unported_family_and_kind_raise():
    """Every kind and config of the reference builds: the recurrent kinds
    (mamba, mlstm, slstm) and xlstm-350m / whisper-large-v3 since the
    tenth slice; the spatial-filter config is no model, and ``build``
    refuses it with the reference's ValueError (before it asks for a
    device)."""
    assert transformer.NOT_PORTED == ()
    mc = dataclasses.replace(tiny_of("yi_6b"), family="ssm", slstm_every=2)
    b = registry.build(RunConfig(model=mc, shape=SHAPES["train_4k"]),
                       device="cpu")
    assert {st.kind for st in transformer.make_stages(mc)} == {"mlstm",
                                                               "slstm"}
    assert "stage_1" in b.specs
    mc = dataclasses.replace(tiny_of("hymba_1_5b"),
                             stage_override=(("mamba", 0, 4),))
    assert set(transformer.model_specs(mc)["stage_0"]) == {"ln1", "mamba"}
    for arch in ("xlstm_350m", "whisper_large_v3"):
        assert dataclasses.asdict(get_model_config(arch)) == \
            dataclasses.asdict(r_get_model_config(arch))
        registry.build(RunConfig(model=tiny_of(arch),
                                 shape=SHAPES["train_4k"]), device="cpu")
    spatial = get_model_config("spatial_filter_hd")
    assert dataclasses.asdict(spatial) == \
        dataclasses.asdict(r_get_model_config("spatial_filter_hd"))
    with pytest.raises(ValueError, match="repro_torch.core"):
        registry.build(RunConfig(model=spatial, shape=SHAPES["train_4k"]))
    with pytest.raises(ValueError, match="repro.core"):
        r_registry.build(RRunConfig(model=r_get_model_config(
            "spatial_filter_hd"), shape=R_SHAPES["train_4k"],
            mesh=SINGLE_POD))
    with pytest.raises(ValueError, match="no config"):
        get_model_config("llama_9000")
    for arch in NEW_ARCHS + ["qwen2_vl_7b"]:
        registry.build(RunConfig(model=tiny_of(arch),
                                 shape=SHAPES["train_4k"]), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_matches_reference(use_kernel, dtype, rng):
    """One mamba block at hymba's (tiny) structure, as the reference's
    tests/test_pallas_in_model.py runs it, against the reference's own
    block with the same conv branch."""
    rmc = dataclasses.replace(r_tiny_of("hymba_1_5b"), num_meta_tokens=0,
                              dtype=dtype)
    mc = dataclasses.replace(tiny_of("hymba_1_5b"), num_meta_tokens=0,
                             dtype=dtype)
    rspecs = r_ssm.mamba_specs(rmc.d_model, expand=rmc.ssm_expand,
                               heads=rmc.mamba_heads, state=rmc.ssm_state,
                               conv_width=rmc.ssm_conv_width)
    rparams = r_module.init_params(rspecs, jax.random.key(3))
    x = rng.standard_normal((2, 32, mc.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref, rstate = r_ssm.mamba_block(jnp.asarray(x).astype(jdt), rparams, rmc,
                                    use_pallas_conv=use_kernel)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    before = DW.dwconv1d.launches
    got, state = ssm.mamba_block(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 params, mc, use_pallas_conv=use_kernel)
    assert DW.dwconv1d.launches == before          # CPU: plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = {"float32": 3e-4, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(state["ssm"].numpy(),
                               np.asarray(rstate["ssm"]), rtol=tol, atol=tol)
    assert (state["conv"] is None) == use_kernel


def test_mamba_chunk_rule_and_ragged_length(rng):
    """S that no chunk divides (the gcd fallback, then one chunk)."""
    rmc = dataclasses.replace(r_tiny_of("hymba_1_5b"), num_meta_tokens=0,
                              ssd_chunk=16)
    mc = dataclasses.replace(tiny_of("hymba_1_5b"), num_meta_tokens=0,
                             ssd_chunk=16)
    rspecs = r_ssm.mamba_specs(rmc.d_model, expand=rmc.ssm_expand,
                               heads=rmc.mamba_heads, state=rmc.ssm_state,
                               conv_width=rmc.ssm_conv_width)
    rparams = r_module.init_params(rspecs, jax.random.key(4))
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    for S in (48, 37):
        x = rng.standard_normal((1, S, mc.d_model)).astype(np.float32)
        ref, _ = r_ssm.mamba_block(jnp.asarray(x), rparams, rmc)
        got, _ = ssm.mamba_block(torch.from_numpy(x), params, mc,
                                 use_pallas_conv=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-4,
                                   atol=3e-4)
