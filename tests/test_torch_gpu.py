"""The CUDA kernels on the card, each held against its plain torch
version, and the main paths through them (serving, the LM forward, the
mamba block) held against the same paths on the CPU (which the CPU
suites hold against the reference package). Marked
``gpu``; each test decides inside the ``cuda`` fixture whether a card is
there and skips with a reason where there is none. The machine with the
card has no JAX, so this file imports only the port. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K

pytestmark = pytest.mark.gpu

POLICIES = ("neglect", "constant", "wrap", "duplicate", "mirror_dup",
            "mirror")
FORMS = ("direct", "transposed", "tree", "compress", "separable")
DTYPES = ("float32", "bfloat16", "int8", "uint8", "int16")
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frame(rng, dtype, shape):
    if dtype in TOL:
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(getattr(torch, dtype))
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, int(info.max) + 1, shape)
                            .astype(dtype))


def _coeffs(rng, dtype, shape):
    if dtype in TOL:
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                / shape[-1])
    return torch.from_numpy(rng.integers(-9, 10, shape).astype(np.int32))


def _same(got, ref, dtype):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if dtype in TOL:
        torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    else:
        assert torch.equal(got, ref)


def _launch(x, co, plan, q, form, loader):
    """One kernel launch, checked to have taken ``loader``."""
    before = (K.filter2d_halo.launches, K.filter2d_halo.tma_launches)
    got = K.filter2d_halo(x, co, plan, q_params=q, form=form)
    tma = int(loader == "tma")
    assert (K.filter2d_halo.launches, K.filter2d_halo.tma_launches) == (
        before[0] + 1, before[1] + tma), loader
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_matches_plain_version(cuda, policy, dtype, rng):
    for form in FORMS:
        for w in (3, 5, 7):
            n = 1 if form == "separable" else 3
            x = _frame(rng, dtype, (2, 37, 70)).to(cuda)
            co = _coeffs(rng, dtype, (n, 2, w) if form == "separable"
                         else (n, w, w)).to(cuda)
            rq = q = None
            if dtype not in TOL:
                rq = RequantSpec(rounding="nearest_even", dtype=dtype)
                q = torch.tensor([[3, 2]] * n, dtype=torch.int32,
                                 device=cuda)
            const = 3.7 if dtype in TOL else -300.0
            plan = halo.make_plan(37, 70, w, BorderSpec(policy, const), 37,
                                  70, dtype=dtype, requant=rq)
            got = _launch(x, co, plan, q, form, "thread")  # 70 cols: unaligned
            ref = K.filter2d_halo_ref(x, co, plan, q_params=q, form=form)
            torch.cuda.synchronize()
            _same(got, ref, dtype)


def _case(rng, dtype, policy, form, w, shape, n, rounding, cuda):
    """Planes, a bank of n (1 for separable), the plan and gains."""
    x = _frame(rng, dtype, shape).to(cuda)
    n = 1 if form == "separable" else n
    co = _coeffs(rng, dtype, (n, 2, w) if form == "separable"
                 else (n, w, w)).to(cuda)
    rq = q = None
    if dtype not in TOL:
        rq = RequantSpec(rounding=rounding, dtype=dtype)
        q = torch.from_numpy(np.stack([rng.integers(-(1 << 12), 1 << 12, n),
                                       rng.integers(0, 21, n)], axis=1)
                             .astype(np.int32)).to(cuda)
    const = 3.7 if dtype in TOL else -300.0
    plan = halo.make_plan(shape[1], shape[2], w, BorderSpec(policy, const),
                          shape[1], shape[2], dtype=dtype, requant=rq)
    return x, co, plan, q


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_tma_loader_matches_plain_version(cuda, policy, dtype, rng):
    """Rows 16-byte aligned for every dtype (W 336, 208): the TMA loader.
    W 336 is ragged against the 128-column tile, H 67 and 97 against every
    strip height; a bank of 4; the integer frames cycle the roundings."""
    k = 0
    for shape in ((2, 67, 336), (1, 97, 208)):
        for form in FORMS:
            for w in (3, 5, 7):
                rounding = ("truncate", "nearest", "nearest_even")[k % 3]
                k += 1
                x, co, plan, q = _case(rng, dtype, policy, form, w, shape, 4,
                                       rounding, cuda)
                got = _launch(x, co, plan, q, form, "tma")
                ref = K.filter2d_halo_ref(x, co, plan, q_params=q, form=form)
                torch.cuda.synchronize()
                _same(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 48), (1, 8, 16), (3, 33, 144)])
def test_kernel_small_frames_every_policy(cuda, shape, dtype, rng):
    """Frames smaller than one tile and one strip, through TMA: wrap and the
    reflections read across all four edges and corners of the frame."""
    for policy in POLICIES[1:]:            # neglect: no output at w 7
        for form, w in (("direct", 7), ("separable", 5), ("tree", 3)):
            if dtype not in TOL and form == "tree":
                form = "compress"          # integer frames: any order
            x, co, plan, q = _case(rng, dtype, policy, form, w, shape, 4,
                                   "nearest", cuda)
            got = _launch(x, co, plan, q, form, "tma")
            ref = K.filter2d_halo_ref(x, co, plan, q_params=q, form=form)
            torch.cuda.synchronize()
            _same(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_reads_a_view_off_16_bytes(cuda, dtype, rng):
    """A contiguous view whose first element is one element past a 16-byte
    boundary: the frame cannot be a TMA map, so the per-thread loader fills
    the same ring; the result is the same."""
    shape = (2, 67, 336)
    x, co, plan, q = _case(rng, dtype, "mirror", "direct", 5, shape, 4,
                           "nearest_even", cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = flat[1:].view(shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert K.loader_for(view) == "thread" and K.loader_for(x) == "tma"
    got = _launch(view, co, plan, q, "direct", "thread")
    want = _launch(x, co, plan, q, "direct", "tma")
    torch.cuda.synchronize()
    _same(got, K.filter2d_halo_ref(x, co, plan, q_params=q), dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(40, 50), (40, 50, 3), (2, 40, 50, 3)])
def test_pipeline_on_the_card_matches_the_cpu(cuda, shape, dtype, rng):
    x = _frame(rng, dtype, shape)
    k = _coeffs(rng, dtype, (4, 5, 5))
    rq = None
    if dtype not in TOL:
        k[:, 2, 2] = 50
        rq = RequantSpec.unity_gain(k.numpy(), dtype)
    spec = Filter2D(window=5, num_filters=4, dtype=dtype, border="mirror",
                    requant=rq.gain_free() if rq else None)
    cf = spec.compile(shape, "auto", device=cuda)
    assert cf.execution == "cuda"
    got = cf(x, k, gains=rq)
    assert got.device.type == "cuda"
    want = spec.compile(shape, "cuda", device="cpu")(x, k, gains=rq)
    _same(got.cpu(), want, dtype)
    with pytest.raises(TypeError):            # float64 has no kernel
        Filter2D(window=5, dtype="float64").compile((8, 8), device=cuda)(
            torch.zeros(8, 8, dtype=torch.float64), torch.ones(5, 5))


def test_engine_on_the_card(cuda):
    from repro_torch.serving import FilterServeEngine
    from repro_torch.serving.bench import build_mix
    templates = build_mix(np.random.default_rng(2), scale=2)
    with FilterServeEngine(batch_size=2, device=cuda) as eng:
        before = K.filter2d_halo.launches
        tma_before = K.filter2d_halo.tma_launches
        reqs = [eng.submit(t.frame, t.coeffs, spec=t.spec, gains=t.gains,
                           tenant=t.tenant) for t in templates * 2]
        assert eng.drain(timeout=120)
        st = eng.stats()
        assert K.filter2d_halo.launches - before == st["waves"]
        # build_mix(scale=2) frames are 256 / 192 columns wide: aligned rows
        assert K.filter2d_halo.tma_launches - tma_before == st["waves"]
    assert st["recompiles"] == 3 and st["errors"] == 0
    with FilterServeEngine(batch_size=2, device="cpu",
                           execution="cuda") as cpu:
        want = [cpu.submit(t.frame, t.coeffs, spec=t.spec, gains=t.gains,
                           tenant=t.tenant) for t in templates * 2]
        assert cpu.drain(timeout=120)
    for r, w, t in zip(reqs, want, templates * 2):
        _same(r.result(timeout=10), w.result(timeout=10), t.spec.dtype)


# -- the strip-scan and library-convolution executors ------------------------

def _executor_case(rng, dtype, policy, shape, w=5):
    x = _frame(rng, dtype, shape)
    k = _coeffs(rng, dtype, (w, w))
    rq = None
    if dtype not in TOL:
        rq = RequantSpec(multiplier=3, shift=6, rounding="nearest",
                         dtype=dtype)
    spec = Filter2D(window=w, dtype=dtype, requant=rq.gain_free() if rq
                    else None, border=BorderSpec(
                        policy, 3.7 if dtype in TOL else -300.0))
    return x, k, rq, spec


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_streaming_on_the_card_matches_cuda(cuda, policy, dtype, rng):
    """One kernel launch per strip (6 strips of 8 rows), each window
    through ``filter2d_halo``: the same kernel and roundings as the cuda
    executor, and the scan's plain version on the CPU."""
    x, k, rq, spec = _executor_case(rng, dtype, policy, (2, 48, 61, 2))
    cf = spec.compile(x.shape, "streaming", strip_h=8, device=cuda)
    before = K.filter2d_halo.launches
    got = cf(x, k, gains=rq)
    assert K.filter2d_halo.launches - before == 6
    ref = spec.compile(x.shape, "cuda", device=cuda)(x, k, gains=rq)
    cpu = spec.compile(x.shape, "streaming", strip_h=8, device="cpu")(
        x, k, gains=rq)
    torch.cuda.synchronize()
    _same(got, ref, dtype)
    _same(got.cpu(), cpu, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_xla_on_the_card_matches_cuda(cuda, policy, dtype, rng):
    """``F.conv2d`` with TF32 off around the call (the caller's TF32 flag
    comes back as it was), held against the cuda executor."""
    x, k, rq, spec = _executor_case(rng, dtype, policy, (2, 40, 50, 3))
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        got = spec.compile(x.shape, "xla", device=cuda)(x, k, gains=rq)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ref = spec.compile(x.shape, "cuda", device=cuda)(x, k, gains=rq)
    torch.cuda.synchronize()
    _same(got, ref, dtype)


@pytest.mark.parametrize("w", [5, 7, 13, 15])
def test_xla_overflow_edge_on_the_card(cuda, w):
    """All-max int16 under duplicate: every output is 32767 · Σk wrapped
    to int32. Past w 11 'xla' splits the coefficients in 16-bit halves;
    the kernel stops at w 7, so those windows are held against the plain
    'core' executor on the CPU and the closed form."""
    x = torch.full((2, 40, 70), 32767, dtype=torch.int16)
    k = torch.full((w, w), 1 << 20, dtype=torch.int32)
    if w > 7:                   # a negative tap and a low half that carries
        k[0, 0], k[w // 2, w // 2] = -(1 << 31), 0x7FFFBEEF
    spec = Filter2D(window=w, dtype="int16", border="duplicate")
    got = spec.compile(x.shape, "xla", device=cuda)(x, k)
    if w in K.KERNEL_WINDOWS:
        ref = spec.compile(x.shape, "cuda", device=cuda)(x, k)
    else:
        ref = spec.compile(x.shape, "core", device="cpu")(x, k).to(cuda)
    edge = (32767 * int(k.long().sum()) + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert bool((got == edge).all())


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_sharded_on_the_card_matches_cuda(cuda, policy, dtype, shards, rng):
    """A ring over ``shards`` entries of the one card, fed a host frame:
    one kernel launch per shard on its window, the same kernel and
    roundings as the cuda executor, and the ring's plain version on the
    CPU."""
    x, k, rq, spec = _executor_case(rng, dtype, policy, (2, 48, 61, 2))
    cf = spec.compile(x.shape, "sharded", mesh=[cuda] * shards)
    before = K.filter2d_halo.launches
    got = cf(x, k, gains=rq)
    assert K.filter2d_halo.launches - before == shards
    assert got.device == cf.mesh.devices[0]
    ref = spec.compile(x.shape, "cuda", device=cuda)(x.to(cuda), k,
                                                      gains=rq)
    cpu = spec.compile(x.shape, "sharded", mesh=["cpu"] * shards)(
        x, k, gains=rq)
    torch.cuda.synchronize()
    _same(got, ref, dtype)
    _same(got.cpu(), cpu, dtype)


def test_sharded_mesh_and_device_must_agree(cuda):
    spec = Filter2D(window=3)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        spec.compile((16, 16), "sharded", mesh=["cpu"] * 2, device=cuda)
    with pytest.raises(ValueError, match="all CUDA devices or all"):
        spec.compile((16, 16), "sharded", mesh=[cuda, "cpu"])


@pytest.mark.parametrize("execution", ["streaming", "xla"])
def test_engine_on_the_card_other_executors(cuda, execution):
    from repro_torch.serving import FilterServeEngine
    from repro_torch.serving.bench import build_mix
    templates = build_mix(np.random.default_rng(3), scale=2) * 2
    results = {}
    for device in (cuda, "cpu"):
        with FilterServeEngine(batch_size=2, device=device,
                               execution=execution) as eng:
            reqs = [eng.submit(t.frame, t.coeffs, spec=t.spec,
                               gains=t.gains, tenant=t.tenant)
                    for t in templates]
            assert eng.drain(timeout=120)
            st = eng.stats()
        assert st["recompiles"] == 3 and st["errors"] == 0
        results[str(device)] = [r.result(timeout=10) for r in reqs]
    for g, w, t in zip(results[str(cuda)], results["cpu"], templates):
        _same(g, w, t.spec.dtype)


# -- the LM slice: swattn, dwconv1d, the forward and the mamba block ----------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1), (32, 8), (8, 8)])
def test_swattn_kernel_matches_plain_version(cuda, H, KV, hd, dtype, rng):
    """The edge sweep of the kernel's tile geometry: S on both sides of
    one, two and three 64-row warpgroup tiles (a bf16 block holds 128 or
    192 rows), windows on both sides of one key tile (``tile_keys``), and
    windows of 0 (full causal) and past S."""
    from repro_torch.kernels.swattn import kernel as SW
    dt = getattr(torch, dtype)
    bk = SW.tile_keys(dt)
    cases = [(S, w) for S in (1, 63, 64, 65, 127, 128, 129, 191, 192,
                              193, 1000)
             for w in (0, 1, bk - 1, bk, bk + 1, 300, S + 7)]
    for S, window in [(77, 0), (77, 20), (130, 33), (40, 500)] + cases:
        q = torch.from_numpy(rng.standard_normal((3, S, H, hd))
                             .astype(np.float32)).to(cuda, dt)
        k, v = (torch.from_numpy(rng.standard_normal((3, S, KV, hd))
                                 .astype(np.float32)).to(cuda, dt)
                for _ in range(2))
        before = SW.swattn.launches
        got = SW.swattn(q, k, v, window=window, scale=hd ** -0.5)
        assert SW.swattn.launches == before + 1
        ref = SW.swattn_ref(q, k, v, window=window, scale=hd ** -0.5)
        torch.cuda.synchronize()
        _same(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_swattn_kernel_reads_views_at_any_offset(cuda, offset, dtype, rng):
    """Contiguous views that start ``offset`` elements into their storage:
    the bf16 kernel's TMA needs 16-byte aligned bases, so the wrapper
    copies a view that does not start on one; the result is the same."""
    from repro_torch.kernels.swattn import kernel as SW
    dt = getattr(torch, dtype)
    B, S, H, KV, hd = 2, 130, 8, 2, 80

    def view(h):
        n = B * S * h * hd
        flat = torch.empty(n + offset, dtype=dt, device=cuda)
        t = flat[offset:].view(B, S, h, hd)
        t.copy_(torch.from_numpy(rng.standard_normal((B, S, h, hd))
                                 .astype(np.float32)))
        return t

    q, k, v = view(H), view(KV), view(KV)
    assert q.is_contiguous() and q.storage_offset() == offset
    for window in (0, 33):
        before = SW.swattn.launches
        got = SW.swattn(q, k, v, window=window, scale=hd ** -0.5)
        assert SW.swattn.launches == before + 1
        ref = SW.swattn_ref(q, k, v, window=window, scale=hd ** -0.5)
        torch.cuda.synchronize()
        _same(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
def test_dwconv1d_kernel_matches_plain_version(cuda, k, dtype, rng):
    from repro_torch.kernels.dwconv1d import kernel as DW
    dt = getattr(torch, dtype)
    for B, S, C in ((2, 37, 130), (1, 5, 3200), (3, 64, 33)):
        x = torch.from_numpy(rng.standard_normal((B, S, C))
                             .astype(np.float32)).to(cuda, dt)
        w = torch.from_numpy(rng.standard_normal((k, C)).astype(np.float32)
                             / k).to(cuda, dt)
        b = torch.from_numpy(rng.standard_normal(C).astype(np.float32)
                             ).to(cuda, dt)
        before = DW.dwconv1d.launches
        got = DW.dwconv1d(x, w, b)
        assert DW.dwconv1d.launches == before + 1
        ref = DW.dwconv1d_ref(x, w, b)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)          # the plain version's roundings


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "yi_6b"])
def test_lm_forward_on_the_card_matches_the_cpu(cuda, arch, rng):
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.kernels.swattn import kernel as SW
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = dataclasses.replace(tiny_of(arch), use_pallas_attn=True)
    rc = RunConfig(model=mc, shape=SHAPES["train_4k"])
    toks = torch.from_numpy(rng.integers(0, 255, (2, 61)))
    cpu = registry.build(rc, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(7))
    want, _ = cpu.train_forward(params, {"inputs": toks})
    card = registry.build(rc, device=cuda)
    on_card = _to(params, cuda)
    before = SW.swattn.launches
    got, _ = card.train_forward(on_card, {"inputs": toks})
    assert SW.swattn.launches - before == mc.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_on_the_card_matches_the_cpu(cuda, use_kernel, rng):
    import dataclasses
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.models import module, ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = dataclasses.replace(tiny_of("hymba_1_5b"), num_meta_tokens=0)
    specs = ssm.mamba_specs(mc.d_model, expand=mc.ssm_expand,
                            heads=mc.mamba_heads, state=mc.ssm_state,
                            conv_width=mc.ssm_conv_width)
    params = module.init_params(specs, torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((2, 48, mc.d_model))
                         .astype(np.float32))
    want, _ = ssm.mamba_block(x, params, mc, use_pallas_conv=use_kernel)
    card = _to(params, cuda)
    before = DW.dwconv1d.launches
    got, _ = ssm.mamba_block(x.to(cuda), card, mc,
                             use_pallas_conv=use_kernel)
    assert DW.dwconv1d.launches - before == int(use_kernel)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "yi_6b", "hymba_1_5b",
                                  "mixtral_8x7b", "qwen3_moe_30b_a3b",
                                  "gemma3_4b", "codeqwen15_7b"])
def test_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch, use_kernel,
                                                      rng):
    """Tiny prefill (24 tokens: h2o-danube's ring of 8 takes the eviction
    write, hymba its sink slots) and three decode steps on the card
    against the same calls on the CPU (which tests/test_torch_decode.py
    holds against the reference): logits within rtol=atol=3e-4 after
    prefill and 5e-4 after each step, the caches' positions exactly and
    their values within 5e-4. The kernel gate sends each prefill layer
    through swattn (not hymba's: its meta tokens bar the kernel); decode
    never launches it."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.kernels.swattn import kernel as SW
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = dataclasses.replace(tiny_of(arch), use_pallas_attn=use_kernel)
    rc = RunConfig(model=mc, shape=dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=32, global_batch=2))
    toks = torch.from_numpy(rng.integers(0, 255, (2, 27)))
    cpu = registry.build(rc, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(7))
    card = registry.build(rc, device=cuda)
    on_card = _to(params, cuda)
    want, want_c = cpu.prefill(params, {"inputs": toks[:, :24]})
    before = SW.swattn.launches
    got, got_c = card.prefill(on_card, {"inputs": toks[:, :24]})
    gated = use_kernel and not mc.num_meta_tokens
    assert SW.swattn.launches - before == (mc.num_layers if gated else 0)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)
    for i in range(3):
        cur = 24 + mc.num_meta_tokens + i
        want, _ = cpu.decode_step(params, toks[:, 24 + i:25 + i], want_c, cur)
        before = SW.swattn.launches
        got, _ = card.decode_step(on_card, toks[:, 24 + i:25 + i], got_c, cur)
        assert SW.swattn.launches == before
        torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-4)
    for g, w in zip(got_c, want_c):
        for key, leaf in _flat(w):
            other = dict(_flat(g))[key].cpu()
            if leaf.is_floating_point():
                torch.testing.assert_close(other, leaf, rtol=5e-4, atol=5e-4)
            else:
                assert torch.equal(other, leaf), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["drops", "last_expert_overfull", "decode"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, case, dtype, rng):
    """``moe_block`` on the card against the CPU (which
    tests/test_torch_moe.py holds against the reference): at the published
    capacity with drops, with the last expert overfilled (the sentinel
    slot's last write must win on the card as on the CPU), and the decode
    grouping ([1, B, D]). float32 within rtol=atol=1e-5 (TF32 off),
    bfloat16 within 3e-2; two calls on the card are bit-equal (the
    dispatch and the combine use no atomics)."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, D, F, E, k = {"drops": (2, 96, 32, 48, 8, 2),
                        "last_expert_overfull": (2, 24, 32, 48, 4, 2),
                        "decode": (1, 6, 32, 48, 16, 8)}[case]
    g = torch.Generator().manual_seed(9)
    params = {"router": torch.randn((D, E), generator=g),
              "wi": torch.randn((E, D, F), generator=g) / D ** 0.5,
              "wg": torch.randn((E, D, F), generator=g) / D ** 0.5,
              "wo": torch.randn((E, F, D), generator=g) / F ** 0.5}
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    if case == "last_expert_overfull":
        params["router"] = torch.zeros((D, E))
        params["router"][:, E - 1], params["router"][:, 0] = 4.0, 1.0
        x = x.abs()
    cf = 1.0 if case == "last_expert_overfull" else 1.25
    dt = getattr(torch, dtype)
    want, want_aux = moe.moe_block(x.to(dt), params, num_experts=E, k=k,
                                   capacity_factor=cf)
    on_card = {n: t.to(cuda) for n, t in params.items()}
    got, aux = moe.moe_block(x.to(cuda, dt), on_card, num_experts=E, k=k,
                             capacity_factor=cf)
    again, _ = moe.moe_block(x.to(cuda, dt), on_card, num_experts=E, k=k,
                             capacity_factor=cf)
    assert torch.equal(got, again)
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


# the recurrent kinds and the encoder-decoder: (arch, fields replaced)
RECURRENT = {"xlstm": ("xlstm_350m", {}),
             "mamba": ("hymba_1_5b", {"stage_override": (("mamba", 0, 2),),
                                      "num_layers": 2,
                                      "num_meta_tokens": 0}),
             "whisper": ("whisper_large_v3", {})}


@pytest.mark.parametrize("model", sorted(RECURRENT))
def test_recurrent_and_encdec_serving_on_the_card_match_the_cpu(cuda, model,
                                                                rng):
    """Tiny prefill and 20 decode steps of the tiny xlstm (mLSTM and sLSTM
    states), a mamba stack and whisper (its ring of 16 slots wraps, its
    positions pass the 16 learned ones) on the card against the same
    calls on the CPU (which tests/test_torch_xlstm.py and
    tests/test_torch_whisper.py hold against the reference): float32,
    TF32 off; logits within rtol=atol=3e-4 after prefill and 5e-4 after
    each step, every cache leaf within 5e-4 (positions exactly); no
    kernel launched."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.kernels.swattn import kernel as SW
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, fields = RECURRENT[model]
    mc = dataclasses.replace(tiny_of(arch), **fields)
    rc = RunConfig(model=mc, shape=dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=48, global_batch=2))
    cpu = registry.build(rc, device="cpu")
    card = registry.build(rc, device=cuda)
    params = cpu.init_params(torch.Generator().manual_seed(7))
    on_card = _to(params, cuda)
    P = 4 if model == "whisper" else 24
    toks = torch.from_numpy(rng.integers(0, 255, (2, P + 20)))
    batch = {"inputs": toks[:, :P]}
    if model == "whisper":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 48, mc.d_model)).astype(np.float32)),
            "dec_tokens": toks[:, :P]}
    before = SW.swattn.launches, DW.dwconv1d.launches
    want, want_c = cpu.prefill(params, batch)
    got, got_c = card.prefill(on_card, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=3e-4, atol=3e-4)
    for i in range(20):
        want, _ = cpu.decode_step(params, toks[:, P + i:P + i + 1], want_c,
                                  P + i)
        got, _ = card.decode_step(on_card, toks[:, P + i:P + i + 1], got_c,
                                  P + i)
        torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-4)
    assert (SW.swattn.launches, DW.dwconv1d.launches) == before
    got_leaves = dict(_flat(got_c))
    for key, leaf in _flat(want_c):
        other = got_leaves[key].cpu()
        if leaf.is_floating_point():
            torch.testing.assert_close(other, leaf, rtol=5e-4, atol=5e-4)
        else:
            assert torch.equal(other, leaf), key


# -- the training slice: a step on the card, the kernels' refusal -----------


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "hymba_1_5b",
                                  "xlstm_350m", "whisper_large_v3"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, microbatch):
    """Two float32 train steps (TF32 off) on the card against the same
    steps on the CPU (which tests/test_torch_train.py holds against the
    reference): the loss and the gradient norm within relative 1e-5, the
    clipped gradients and the parameters within relative L2 1e-4 (the CPU
    suite's bar against the reference: hymba's SSD sums read 1.3e-5 on an
    H100); no kernel launched (the config's gate is off, as the reference
    trains)."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.data import make_train_batch
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.kernels.swattn import kernel as SW
    from repro_torch.models import registry
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    rc = RunConfig(model=tiny_of(arch), shape=dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=4),
        train=TrainConfig(microbatch=microbatch, warmup_steps=2))
    params0 = registry.build(rc, device="cpu").init_params(
        torch.Generator().manual_seed(5))

    def run(dev):
        """Two steps from a copy of params0 on ``dev``: (metrics, the
        parameters, the last step's clipped gradients), on the host."""
        b = registry.build(rc, device=dev)
        params = _copy(params0, dev)
        opt = adamw_init(params)
        step = make_train_step(b, rc)
        before = SW.swattn.launches, DW.dwconv1d.launches
        metrics = []
        for i in range(2):
            params, opt, m = step(params, opt, make_train_batch(rc, i, dev))
            metrics.append({k: float(v) for k, v in m.items()})
        assert (SW.swattn.launches, DW.dwconv1d.launches) == before
        leaves = tree_leaves(params)
        return (metrics, [p.cpu() for p in leaves],
                [p.grad.cpu() for p in leaves])

    def rel(a, b):
        num = sum(float((x.double() - y.double()).square().sum())
                  for x, y in zip(a, b))
        return (num / sum(float(y.double().square().sum()) for y in b)) ** .5
    want_m, want_p, want_g = run("cpu")
    got_m, got_p, got_g = run(cuda)
    for g, w in zip(got_m, want_m):
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    assert rel(got_g, want_g) <= 1e-4
    assert rel(got_p, want_p) <= 1e-4


def _copy(tree, device):
    """A copy of a parameter tree on ``device`` (a CPU tree's ``.to('cpu')``
    would be the same tensors, which the step updates in place)."""
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def test_kernels_refuse_a_gradient_on_the_card(cuda, rng):
    from repro_torch.kernels.dwconv1d import dwconv1d_cuda
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.kernels.swattn import kernel as SW
    from repro_torch.kernels.swattn import swattn_cuda
    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    kv = torch.randn(1, 64, 1, 64, device=cuda)
    x = torch.randn(2, 64, 32, device=cuda, requires_grad=True)
    w, b = torch.randn(32, 4, device=cuda), torch.zeros(32, device=cuda)
    before = SW.swattn.launches, DW.dwconv1d.launches
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        swattn_cuda(q, kv, kv, window=16)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        dwconv1d_cuda(x, w, b)
    assert (SW.swattn.launches, DW.dwconv1d.launches) == before
    with torch.no_grad():                     # no gradient asked: launches
        swattn_cuda(q, kv, kv, window=16)
        dwconv1d_cuda(x, w, b)
    assert (SW.swattn.launches, DW.dwconv1d.launches) == (before[0] + 1,
                                                          before[1] + 1)
