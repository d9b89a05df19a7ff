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
    'cuda' runs every odd window (w 13 and 15 on its generic
    instantiation), so both are held against each other on the card, and
    against the closed form."""
    x = torch.full((2, 40, 70), 32767, dtype=torch.int16)
    k = torch.full((w, w), 1 << 20, dtype=torch.int32)
    if w > 7:                   # a negative tap and a low half that carries
        k[0, 0], k[w // 2, w // 2] = -(1 << 31), 0x7FFFBEEF
    spec = Filter2D(window=w, dtype="int16", border="duplicate")
    got = spec.compile(x.shape, "xla", device=cuda)(x, k)
    before = K.filter2d_halo.launches
    ref = spec.compile(x.shape, "cuda", device=cuda)(x, k)
    assert K.filter2d_halo.launches == before + 1
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
    192 rows) and, for float32, of one and two blocks (``tile_queries``),
    an S that is no multiple of 4 at hd 16 and 256 (the float2 and float4
    paths), windows on both sides of one key tile (``tile_keys``), and
    windows of 0 (full causal) and past S."""
    from repro_torch.kernels.swattn import kernel as SW
    dt = getattr(torch, dtype)
    bk = SW.tile_keys(dt)
    lengths = [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 1000]
    if dtype == "float32":
        bq = SW.tile_queries(dt)
        lengths += [S for S in (bq - 1, bq, bq + 1, 2 * bq - 1, 2 * bq,
                                2 * bq + 1) if S not in lengths]
    if hd in (16, 256):
        lengths.append(1001)
    cases = [(S, w) for S in lengths
             for w in (0, 1, bk - 1, bk, bk + 1, 300, S + 7)]
    for S, window in [(77, 0), (77, 20), (130, 33), (40, 500)] + cases:
        q = torch.from_numpy(rng.standard_normal((3, S, H, hd))
                             .astype(np.float32)).to(cuda, dt)
        k, v = (torch.from_numpy(rng.standard_normal((3, S, KV, hd))
                                 .astype(np.float32)).to(cuda, dt)
                for _ in range(2))
        before = SW.swattn.launches, SW.swattn.dtype_launches[dtype]
        got = SW.swattn(q, k, v, window=window, scale=hd ** -0.5)
        assert (SW.swattn.launches, SW.swattn.dtype_launches[dtype]) == (
            before[0] + 1, before[1] + 1)
        ref = SW.swattn_ref(q, k, v, window=window, scale=hd ** -0.5)
        torch.cuda.synchronize()
        _same(got, ref, dtype)


@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.5])
def test_swattn_float32_kernel_takes_any_scale(cuda, scale, rng):
    """The float32 kernel at a negative scale (it negates its Q tile and
    uses |scale|), a zero one (uniform weights over the band) and a large
    one, against the plain version, at two head dims and across tile
    edges."""
    from repro_torch.kernels.swattn import kernel as SW
    dtype, dt = "float32", torch.float32
    for hd, S, window in ((80, 130, 0), (80, 200, 65), (256, 129, 33)):
        q = torch.from_numpy(rng.standard_normal((2, S, 4, hd))
                             .astype(np.float32)).to(cuda, dt)
        k, v = (torch.from_numpy(rng.standard_normal((2, S, 2, hd))
                                 .astype(np.float32)).to(cuda, dt)
                for _ in range(2))
        got = SW.swattn(q, k, v, window=window, scale=scale)
        ref = SW.swattn_ref(q, k, v, window=window, scale=scale)
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


@pytest.mark.parametrize("axes", [("pod", "data", "model"),
                                  ("data", "model")])
def test_int8_ef_dp_step_on_the_card_matches_the_cpu(cuda, axes,
                                                     monkeypatch):
    """Two float32 int8-EF data-parallel steps (TF32 off) on a mesh of
    four ``cuda:0`` entries against the same steps, in turns, on four
    CPU entries (which tests/test_torch_dp.py holds against the
    reference's own 4-device step): the loss within relative 1e-5; the
    clipped gradients, the parameters and the residuals within relative
    L2 1e-4 wherever the two runs quantise alike. The two devices'
    float32 gradients differ in their last bits, so an int8 value may
    differ by one where the CPU's ``(g + err) / scale`` lies within
    ``HALF_TOL`` of a halfway point; such elements (a quantisation step
    apart from then on) are left out, and only they."""
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.data import make_train_batch
    from repro_torch.models import registry
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.training import dp_shardmap
    HALF_TOL = 1e-3
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (2, 2, 1) if len(axes) == 3 else (2, 2)
    rc = RunConfig(model=tiny_of("yi_6b"), shape=dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=8),
        train=TrainConfig(warmup_steps=2))
    params0 = registry.build(rc, device="cpu").init_params(
        torch.Generator().manual_seed(6))
    seen = []                           # (q, (g + err) / scale) per call
    compress = dp_shardmap.int8_ef_compress

    def recording(g, e, fma=False):
        q, scale, new_e = compress(g, e, fma=fma)
        seen.append((q.cpu().numpy(), ((g.float() + e) / scale).cpu().numpy()))
        return q, scale, new_e

    monkeypatch.setattr(dp_shardmap, "int8_ef_compress", recording)
    runs = {}
    for dev in ("cpu", "cuda:0"):
        mesh = make_mesh(shape, axes, [dev] * 4)
        params = _copy(params0, dev)
        runs[dev] = [params, adamw_init(params),
                     dp_shardmap.init_error_feedback(params, mesh),
                     dp_shardmap.make_compressed_dp_step(
                         registry.build(rc, device=dev), rc, mesh)]

    def rel(a, b, keep):
        num = sum(float(np.square((x - y)[k]).sum())
                  for x, y, k in zip(a, b, keep))
        den = sum(float(np.square(y[k]).sum()) for y, k in zip(b, keep))
        return (num / den) ** .5 if den else num ** .5
    flipped = None
    for i in range(2):
        out = {}
        for dev, (params, opt, err, step) in runs.items():
            del seen[:]
            params, opt, err, m = step(params, opt, err,
                                       make_train_batch(rc, i, dev))
            runs[dev][:3] = params, opt, err
            leaves = tree_leaves(params)
            out[dev] = (float(m["loss"]), list(seen),
                        [p.detach().cpu().numpy() for p in leaves],
                        [p.grad.cpu().numpy() for p in leaves],
                        [e.cpu().numpy() for e in tree_leaves(err)])
        (lw, sw, pw, gw, ew), (lg, sg, pg, gg, eg) = out["cpu"], \
            out["cuda:0"]
        assert lg == pytest.approx(lw, rel=1e-5)
        assert len(sg) == len(sw) == (2 * len(pw) if len(axes) == 3 else 0)
        if flipped is None:
            flipped = [np.zeros(p.shape, bool) for p in pw]
        for j in range(len(sw) // 2):
            qw = np.stack([sw[2 * j][0], sw[2 * j + 1][0]])
            qg = np.stack([sg[2 * j][0], sg[2 * j + 1][0]])
            u = np.stack([sw[2 * j][1], sw[2 * j + 1][1]])
            new = (qw != qg) & ~flipped[j][None]
            halfway = np.abs(np.abs(u - np.trunc(u)) - 0.5) <= HALF_TOL
            assert not (new & ~halfway).any(), (i, j)
            flipped[j] |= new.any(0)
        keep = [~f for f in flipped]
        assert sum(int(f.sum()) for f in flipped) <= 16
        assert rel(gg, gw, keep) <= 1e-4
        assert rel(pg, pw, keep) <= 1e-4
        assert rel(eg, ew, [np.broadcast_to(k, e.shape)
                            for k, e in zip(keep, ew)]) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpipe_on_the_card_matches_the_cpu(cuda, dtype):
    """The GPipe schedule over 4 ``cuda:0`` stage entries (tiny h2o-danube
    layers, M 8) against the same schedule on the CPU: the loss and the
    gradients within relative 1e-5 (float32, TF32 off) or 3e-2
    (bfloat16)."""
    import dataclasses
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.models import module
    from repro_torch.models import transformer as tfm
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.training.pipeline import pipeline_loss_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = dataclasses.replace(tiny_of("h2o_danube_1_8b"), num_layers=4,
                             dtype=dtype)
    jdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    st0 = module.init_params(tfm.model_specs(mc)["stage_0"], gen, jdt)
    x = torch.randn((8, 1, 32, mc.d_model), generator=gen).to(jdt)
    y = torch.randn((8, 1, 32, mc.d_model), generator=gen).to(jdt)

    def run(dev):
        params = tree_map(lambda a: a.to(dev, copy=True).reshape(
            (4, 1) + a.shape[1:]).requires_grad_(True), st0)
        positions = torch.arange(32, device=dev)[None]
        ctx = {"cos_sin": tfm._positions_cos_sin(mc, positions),
               "q_pos": positions, "window": tfm.make_stages(mc)[0].window,
               "cur": None, "sinks": 0}

        def stage(p, h):
            for lp in tfm._unstack(p, 1):
                h, _ = tfm.dense_block(lp, h, ctx, mc)
            return h
        mesh = make_mesh((4,), ("stage",), [dev] * 4)
        loss = pipeline_loss_fn(stage, lambda o, t: (
            o.float() - t.float()).square().mean(), mesh)(
                params, x.to(dev), y.to(dev))
        leaves = tree_leaves(params)
        return [float(loss)] + [g.float().cpu() for g in
                                torch.autograd.grad(loss, leaves)]

    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    want, got = run("cpu"), run("cuda:0")
    assert got[0] == pytest.approx(want[0], rel=tol)
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).norm() / w.norm()) <= tol


def _spmd_rc():
    import dataclasses
    from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
    from repro_torch.configs.tiny import tiny_of
    return RunConfig(model=tiny_of("yi_6b"), shape=dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=8),
        train=TrainConfig(warmup_steps=2, remat_policy="none"))


def _checkpoint(d, step):
    import json
    import os
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(path, v["file"]))
            for k, v in man["leaves"].items()}


def _same_spmd_run(got, want, got_dir, want_dir, step):
    for k in ("loss", "grad_norm"):
        assert abs(got.final_metrics[k] - want.final_metrics[k]) <= 1e-5 * \
            abs(want.final_metrics[k]), k
    g, w = _checkpoint(got_dir, step), _checkpoint(want_dir, step)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 1), ("pod", "data", "model"))])
def test_train_loop_on_a_mesh_on_the_card_matches_the_cpu(cuda, shape, axes,
                                                          tmp_path):
    """Three float32 steps of ``train_loop(mesh=)`` (TF32 off) on a mesh of
    four ``cuda:0`` entries against the same run on four CPU entries
    (which tests/test_torch_spmd.py holds against the reference's own
    mesh run): loss and grad norm within relative 1e-5, every parameter
    and moment within 1e-4 absolute (the step-3 checkpoints)."""
    from repro_torch.models import registry
    from repro_torch.models.module import tree_map
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.training.trainer import train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    rc = _spmd_rc()
    params0 = registry.build(rc, device="cpu").init_params(
        torch.Generator().manual_seed(6))
    reps = {}
    for dev in ("cpu", "cuda:0"):
        reps[dev] = train_loop(
            rc, num_steps=3, mesh=make_mesh(shape, axes, [dev] * 4),
            params=tree_map(lambda t: t.clone(), params0), log_every=0,
            ckpt_dir=str(tmp_path / dev[:3]), ckpt_every=3)
    _same_spmd_run(reps["cuda:0"], reps["cpu"], tmp_path / "cud",
                   tmp_path / "cpu", 3)


def test_elastic_restart_on_the_card_matches_the_cpu(cuda, tmp_path):
    """3 float32 steps on (data 2) with a checkpoint, 2 more resumed on
    (data 2, model 2), on ``cuda:0`` entries and on CPU entries (the
    CPU's held against the reference's two-phase run by
    tests/test_torch_elastic.py): ``resumed_from`` 3 on both, the step-5
    checkpoints within 1e-4, loss and grad norm within relative 1e-5."""
    from repro_torch.models import registry
    from repro_torch.models.module import tree_map
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.training.trainer import train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    rc = _spmd_rc()
    params0 = registry.build(rc, device="cpu").init_params(
        torch.Generator().manual_seed(7))
    reps = {}
    for dev in ("cpu", "cuda:0"):
        d = str(tmp_path / dev[:3])
        train_loop(rc, num_steps=3, mesh=make_mesh((2,), ("data",),
                                                   [dev] * 2),
                   params=tree_map(lambda t: t.clone(), params0),
                   log_every=0, ckpt_dir=d, ckpt_every=3)
        reps[dev] = train_loop(
            rc, num_steps=2, mesh=make_mesh((2, 2), ("data", "model"),
                                            [dev] * 4),
            log_every=0, ckpt_dir=d, ckpt_every=50)
        assert reps[dev].resumed_from == 3
    _same_spmd_run(reps["cuda:0"], reps["cpu"], tmp_path / "cud",
                   tmp_path / "cpu", 5)


# -- every odd window, any bank, the trace build (F5, the verifier) ---------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [9, 17])
def test_generic_window_is_bit_exact_on_the_card(cuda, w, dtype, form, rng):
    """Windows past the instantiations run on the generic path, bit for
    bit against the plain version on the card, at both loaders."""
    n = 1 if form == "separable" else 2
    co = _coeffs(rng, dtype, (n, 2, w) if form == "separable"
                 else (n, w, w)).to(cuda)
    for W in (301, 336):                      # per-thread, TMA
        x = _frame(rng, dtype, (2, 45, W)).to(cuda)
        plan = halo.make_plan(45, W, w, BorderSpec("mirror"), 45, W,
                              dtype=dtype)
        got = K.filter2d_halo(x, co, plan, form=form)
        assert torch.equal(got, K.filter2d_halo_ref(x, co, plan, form=form))


@pytest.mark.parametrize("form", ["direct", "separable", "tree"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [15, 17, 31, 33])
def test_generic_window_chunk_boundaries_are_bit_exact(cuda, w, dtype, form,
                                                       rng):
    """Either side of the generic path's tap chunks (16 taps: 15 | 17 and
    31 | 33), bit for bit against the plain version, at both loaders."""
    n = 1 if form == "separable" else 2
    co = _coeffs(rng, dtype, (n, 2, w) if form == "separable"
                 else (n, w, w)).to(cuda)
    for W in (301, 336):                      # per-thread, TMA
        x = _frame(rng, dtype, (2, 45, W)).to(cuda)
        plan = halo.make_plan(45, W, w, BorderSpec("constant", 3), 45, W,
                              dtype=dtype)
        got = K.filter2d_halo(x, co, plan, form=form)
        assert torch.equal(got, K.filter2d_halo_ref(x, co, plan, form=form))


@pytest.mark.parametrize("edge", [-128, 127, 128, -129, 200])
@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_generic_8bit_banks_take_either_mac_route(cuda, dtype, edge, rng):
    """An 8-bit direct bank whose coefficients all fit a signed byte runs
    dp4a on packed coefficients, one with a coefficient past it the int32
    MAC: each block decides from its own copy of the bank, so the same
    compiled plan takes either. Both bit for bit, to int32 and through a
    requant; the trace build sees every read of the launch take the route
    the bank calls for (its blocks' packed flag)."""
    from repro_torch.kernels.filter2d import trace
    x = _frame(rng, dtype, (2, 45, 336)).to(cuda)
    route = "dp4a" if -128 <= edge <= 127 else "int32 MAC"
    for w in (9, 13, 17):
        co = _coeffs(rng, dtype, (3, w, w))
        co.view(-1)[5] = edge
        co = co.to(cuda)
        for rounding in (None, "nearest"):
            rq = None if rounding is None else RequantSpec(
                rounding=rounding, dtype=dtype)
            plan = halo.make_plan(45, 336, w, BorderSpec("mirror"), 45, 336,
                                  dtype=dtype, requant=rq)
            q = None if rq is None else torch.tensor(
                rq.params(3), dtype=torch.int32, device=cuda)
            got = K.filter2d_halo(x, co, plan, q_params=q)
            ref = K.filter2d_halo_ref(x, co, plan, q_params=q)
            assert torch.equal(got, ref)
            traced, log = trace.traced_call(x, co, plan, q_params=q)
            assert torch.equal(traced, ref)
            seen = trace.mac_routes(log)
            assert seen[route] > 0 and seen[route] == sum(seen.values())


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("dtype,requant", [
    ("float32", None), ("bfloat16", None), ("int8", None), ("int8", "int8"),
    ("uint8", "uint8"), ("int16", None), ("int16", "int16")])
def test_generic_window_runs_the_largest_window_of_each_datapath(
        cuda, dtype, requant, separable, rng):
    size = {"float32": 4, "bfloat16": 2, "int8": 1, "uint8": 1, "int16": 2}
    so = size[requant] if requant else (size[dtype] if dtype in TOL else 4)
    w = halo.max_ring_window(size[dtype], so, separable)
    rq = None if requant is None else RequantSpec(rounding="nearest_even",
                                                  dtype=requant)
    co = _coeffs(rng, dtype, (1, 2, w) if separable else (1, w, w)).to(cuda)
    # the float datapaths' tree reaches its counter's top levels here
    forms = (["separable"] if separable else
             ["direct"] + (["tree"] if dtype in TOL else []))
    for W in (175, 176):                      # per-thread, TMA
        x = _frame(rng, dtype, (1, w + 6, W)).to(cuda)
        plan = halo.make_plan(w + 6, W, w, BorderSpec("mirror"), w + 6, W,
                              dtype=dtype, requant=rq)
        q = None if rq is None else torch.tensor(
            rq.params(1), dtype=torch.int32, device=cuda)
        for form in forms:
            got = K.filter2d_halo(x, co, plan, q_params=q, form=form)
            assert torch.equal(got, K.filter2d_halo_ref(
                x, co, plan, q_params=q, form=form))


@pytest.mark.parametrize("w", [23, 47])
def test_generic_tree_runs_its_middle_level_cases(cuda, w, rng):
    """The float32 tree at windows whose w*w take the counter's 10- and
    12-level cases, both loaders, bit for bit."""
    co = _coeffs(rng, "float32", (2, w, w)).to(cuda)
    for W in (301, 336):                      # per-thread, TMA
        x = _frame(rng, "float32", (2, 67, W)).to(cuda)
        plan = halo.make_plan(67, W, w, BorderSpec("mirror"), 67, W)
        got = K.filter2d_halo(x, co, plan, form="tree")
        assert torch.equal(got, K.filter2d_halo_ref(x, co, plan,
                                                    form="tree"))


def test_a_bank_past_the_coefficient_file_runs_in_chunks(cuda, rng):
    x = _frame(rng, "int16", (2, 40, 96)).to(cuda)
    co = _coeffs(rng, "int16", (60, 11, 11)).to(cuda)
    plan = halo.make_plan(40, 96, 11, BorderSpec("wrap"), 40, 96,
                          dtype="int16")
    chunks = halo.coeff_chunks(60, halo.plan_ring_geometry(plan))
    before = K.filter2d_halo.launches
    got = K.filter2d_halo(x, co, plan)
    assert K.filter2d_halo.launches - before == len(chunks) > 1
    assert torch.equal(got, K.filter2d_halo_ref(x, co, plan))


@pytest.mark.parametrize("loader", ["tma", "thread"])
@pytest.mark.parametrize("dtype,policy", [("float32", "constant"),
                                          ("int8", "wrap")])
def test_trace_build_log_equals_the_schedule_model(cuda, dtype, policy,
                                                   loader, rng):
    """The trace build's events equal ``schedule_model``'s, the passes
    are clean on the card's log, and its output is the kernel's."""
    from repro_torch import analysis
    from repro_torch.kernels.filter2d import trace
    W = 320
    x = _frame(rng, dtype, (2, 70, W)).to(cuda)
    co = _coeffs(rng, dtype, (3, 5, 5)).to(cuda)
    plan = halo.make_plan(70, W, 5, BorderSpec(policy, -3), 70, W,
                          dtype=dtype)
    out, log = trace.traced_call(x, co, plan, loader=loader, blocks=3)
    ct = K.kernel_contract(plan, 3, "direct", dtype, loader)
    dev = analysis.from_device_log(log, contract=ct, plan=plan, M=2)
    model = analysis.schedule_model(ct, halo.plan_ring_geometry(plan), plan,
                                    2, 3)
    assert analysis.schedule_diff(model, dev) == []
    report = analysis.verify_kernel(plan, num_filters=3, dtype=dtype, M=2,
                                    loader=loader, blocks=3,
                                    schedule=lambda *a: dev)
    assert report.clean, report.render()
    assert torch.equal(out, K.filter2d_halo_ref(x, co, plan))
