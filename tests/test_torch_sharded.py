"""Port vs reference: the row-sharded executor (``execution='sharded'``) on
the CPU. The reference's ``filter2d_sharded`` runs once per module in a
subprocess on 4 host devices (the host-platform device count must be set
before JAX starts, as in ``tests/test_multidevice.py``) and writes every
case's inputs and output to an ``.npz``; the port runs the same inputs on
a ``["cpu"] * 4`` mesh. Then the port's own rules: 1- and 2-entry meshes
against ``'core'``, the exchange at storage width, one ``filter2d_halo``
call per shard and never the plain forms, the refusals, ``'auto'`` with a
mesh, and ``explain()`` against the reference's."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RMesh

from repro.core.border_spec import BorderSpec as RBorder
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.requant import RequantSpec as RRequant
from repro_torch import obs
from repro_torch.convert import from_reference
from repro_torch.core import borders, distributed, pipeline, streaming
from repro_torch.core.border_spec import SAME_SIZE_POLICIES, BorderSpec
from repro_torch.core.distributed import Mesh, filter2d_sharded
from repro_torch.core.filter2d import _FORM_FNS
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec

from _torch_parity import FORMS, INT_DTYPES, coeffs, frame, to_torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the six same-size policies (zero and constant(c) both 'constant')
POL = {"zero": ("constant", 0.0), "constant": ("constant", 2.0),
       "replicate": ("duplicate", 0.0), "mirror": ("mirror", 0.0),
       "mirror_dup": ("mirror_dup", 0.0), "wrap": ("wrap", 0.0)}
GAINS = ((1, 0), (5, 3), (-7, 11))
# the reference's own limit (tests/test_multidevice.py:46)
F32_TOL = 2e-5

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.border_spec import BorderSpec
from repro.core.distributed import filter2d_sharded
from repro.core.pipeline import Filter2D
from repro.core.requant import RequantSpec
mesh = jax.make_mesh((4,), ("data",))
POL = %r
out = {}
rng = np.random.default_rng(16)
def keep(key, x, k, y):
    out[key + ":x"], out[key + ":k"], out[key + ":y"] = x, k, np.asarray(y)
for name, (pol, c) in POL.items():
    for w in (3, 5, 7):
        for form in %r:
            x = rng.standard_normal((2, 32, 21, 2)).astype(np.float32)
            k = rng.standard_normal((w, w)).astype(np.float32)
            keep(f"float32-{name}-w{w}-{form}", x, k, filter2d_sharded(
                jnp.asarray(x), jnp.asarray(k), mesh, form=form,
                border=BorderSpec(pol, c)))
    for dt in %r:
        for w in (3, 5):
            info = np.iinfo(dt)
            x = rng.integers(info.min, int(info.max) + 1,
                             (32, 19)).astype(dt)
            k = rng.integers(-9, 10, (w, w)).astype(np.int32)
            rq = RequantSpec(multiplier=int(rng.integers(1, 1 << 10)),
                             shift=int(rng.integers(0, 16)),
                             rounding="nearest_even", dtype=dt)
            out[f"{dt}-{name}-w{w}:q"] = np.asarray(
                [rq.multiplier, rq.shift])
            keep(f"{dt}-{name}-w{w}", x, k, filter2d_sharded(
                jnp.asarray(x), jnp.asarray(k), mesh,
                border=BorderSpec(pol, c), requant=rq))
# a gain swap on one compiled ring
x = rng.integers(-128, 128, (2, 16, 23, 3)).astype(np.int8)
k = rng.integers(-9, 10, (3, 3)).astype(np.int32)
cf = Filter2D(window=3, dtype="int8", border=BorderSpec("wrap"),
              requant=RequantSpec(rounding="nearest", dtype="int8")
              ).compile(x, "sharded", mesh=mesh)
for g in %r:
    keep(f"swap-{g[0]}-{g[1]}", x, k, cf(jnp.asarray(x), jnp.asarray(k),
                                          gains=g))
assert cf.cache_size() == 1
np.savez(sys.argv[1], **out)
""" % (POL, FORMS, INT_DTYPES, GAINS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case of the reference's ring, computed once for the module."""
    path = tmp_path_factory.mktemp("sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(path) as z:
        return dict(z)


def _case(ref, key):
    return ref[key + ":x"], ref[key + ":k"], ref[key + ":y"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("w", [3, 5, 7])
@pytest.mark.parametrize("name", sorted(POL))
def test_float32_ring_matches_reference(ref, name, w, form):
    x, k, want = _case(ref, f"float32-{name}-w{w}-{form}")
    got = filter2d_sharded(torch.from_numpy(x), k, ["cpu"] * 4, form=form,
                           border=BorderSpec(*POL[name]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("name", sorted(POL))
def test_fixed_point_ring_matches_reference(ref, name, dtype, w):
    """Storage-width ring, requant per shard: bit for bit."""
    key = f"{dtype}-{name}-w{w}"
    x, k, want = _case(ref, key)
    m, s = (int(v) for v in ref[key + ":q"])
    rq = RequantSpec(multiplier=m, shift=s, rounding="nearest_even",
                     dtype=dtype)
    got = filter2d_sharded(torch.from_numpy(x), k, Mesh(["cpu"] * 4),
                           border=BorderSpec(*POL[name]), requant=rq)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gain_swaps_reuse_the_ring(ref):
    x, k, _ = _case(ref, "swap-1-0")
    spec = Filter2D(window=3, dtype="int8", border="wrap",
                    requant=RequantSpec(rounding="nearest", dtype="int8"))
    cf = spec.compile(x, "sharded", mesh=["cpu"] * 4)
    for g in GAINS:
        got = cf(torch.from_numpy(x), k, gains=g)
        np.testing.assert_array_equal(got.numpy(),
                                      ref[f"swap-{g[0]}-{g[1]}:y"])
    assert cf.cache_size() == 1


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("policy", SAME_SIZE_POLICIES)
def test_small_meshes_match_core(policy, dtype, n, rng):
    """One shard is one launch over the frame under its own policy; two
    shards are each other's neighbours on both sides of the ring."""
    x = to_torch(frame(rng, dtype, (2, 10, 13, 3)), dtype)
    k = coeffs(rng, dtype, (5, 5))
    rq = (RequantSpec(multiplier=3, shift=9, rounding="truncate",
                      dtype=dtype) if dtype == "int16" else None)
    spec = Filter2D(window=5, dtype=dtype, border=BorderSpec(policy, -7.0),
                    requant=None if rq is None else rq.gain_free())
    got = spec.compile(x, "sharded", mesh=["cpu"] * n)(x, k, gains=rq)
    want = spec.compile(x, "core", device="cpu")(x, k, gains=rq)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert torch.equal(got, want)


def test_exchange_keeps_storage_dtype(rng, monkeypatch):
    """The halo rows cross the ring at the storage dtype: 2·r rows per
    shard, as many bytes as ``wire_bytes`` says."""
    shards = [torch.full((3, 6, 11), i, dtype=torch.int8) for i in range(4)]
    tops, bots = distributed._exchange_halos(shards, 2)
    for i in range(4):
        assert tops[i].dtype == bots[i].dtype == torch.int8
        assert tops[i].shape == bots[i].shape == (3, 2, 11)
        assert int(tops[i][0, 0, 0]) == (i - 1) % 4
        assert int(bots[i][0, 0, 0]) == (i + 1) % 4
    seen = []
    real = distributed._exchange_halos

    def spy(shards, r):
        tops, bots = real(shards, r)
        seen.extend(tops + bots)
        return tops, bots
    monkeypatch.setattr(distributed, "_exchange_halos", spy)
    x = to_torch(frame(rng, "int8", (2, 24, 17, 3)), "int8")
    cf = Filter2D(window=5, dtype="int8").compile(x, "sharded",
                                                  mesh=["cpu"] * 4)
    cf(x, coeffs(rng, "int8", (5, 5)))
    assert {t.dtype for t in seen} == {torch.int8}
    assert sum(t.nbytes for t in seen) == cf.wire_bytes == 4 * 2 * 2 * 17 * 6


@pytest.mark.parametrize("policy", ["mirror", "wrap", "constant"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_one_kernel_call_per_shard(policy, n, rng, monkeypatch):
    """Each shard's MAC is the kernel wrapper, once, on its contiguous
    (Hs + 2r) × (W + 2r) window under the ring's neglect plan (one shard:
    the frame's own plan); the plain forms never run."""
    calls = []
    real = streaming.filter2d_halo

    def spy(planes, co, plan, **kw):
        assert planes.is_contiguous() and planes.ndim == 3
        calls.append((tuple(planes.shape), plan.policy))
        return real(planes, co, plan, **kw)

    def refuse(*a, **k):
        raise AssertionError("a plain form ran on the sharded path")
    monkeypatch.setattr(streaming, "filter2d_halo", spy)
    for name in list(_FORM_FNS):
        monkeypatch.setitem(_FORM_FNS, name, refuse)
    x = to_torch(frame(rng, "int16", (2, 24, 30, 3)), "int16")
    k = coeffs(rng, "int16", (5, 5))
    spec = Filter2D(window=5, dtype="int16", border=BorderSpec(policy, 9.0))
    cf = spec.compile(x, "sharded", mesh=["cpu"] * n)
    y = cf(x, k)
    assert cf.n_shards == n
    assert y.shape == (2, 24, 30, 3) and y.dtype == torch.int32
    if n > 1:
        assert calls == [((6, 24 // n + 4, 34), "neglect")] * n
    else:
        assert calls == [((6, 24, 30), policy)]
    monkeypatch.undo()
    assert torch.equal(y, spec.compile(x, "core", device="cpu")(x, k))


@pytest.mark.parametrize("policy", ["constant", "mirror", "mirror_dup",
                                    "duplicate", "wrap"])
@pytest.mark.parametrize("execution", ["sharded", "streaming"])
def test_border_remaps_are_planned_at_compile_time(execution, policy, rng,
                                                   monkeypatch):
    """The ring and the strip scan remap their window indices by the
    policy once, at compile time; a call only gathers by them."""
    x = to_torch(frame(rng, "int8", (2, 32, 19, 2)), "int8")
    k = coeffs(rng, "int8", (5, 5))
    spec = Filter2D(window=5, dtype="int8",
                    border=BorderSpec(policy, 300.0))
    kw = (dict(mesh=["cpu"] * 4) if execution == "sharded"
          else dict(strip_h=8, device="cpu"))
    cf = spec.compile(x, execution, **kw)
    want = spec.compile(x, "core", device="cpu")(x, k)

    def refuse(*a, **kw):
        raise AssertionError("a border remap ran at call time")
    monkeypatch.setattr(borders, "map_index", refuse)
    monkeypatch.setattr(borders, "valid_mask", refuse)
    assert torch.equal(cf(x, k), want)


def test_refusals():
    spec = Filter2D(window=5)
    cpu4 = ["cpu"] * 4
    with pytest.raises(ValueError, match="needs a mesh"):
        spec.compile((16, 16), "sharded", device="cpu")
    for exe in ("core", "cuda", "streaming", "xla"):
        with pytest.raises(ValueError, match="meshes drive 'sharded'"):
            spec.compile((16, 16), exe, mesh=cpu4)
    with pytest.raises(ValueError, match="neglect"):
        Filter2D(window=5, border="neglect").compile((16, 16), "sharded",
                                                     mesh=cpu4)
    with pytest.raises(ValueError, match="banks"):
        Filter2D(window=5, num_filters=2).compile((16, 16), "sharded",
                                                  mesh=cpu4)
    with pytest.raises(ValueError, match="separable"):
        Filter2D(window=5, separable=True).compile((16, 16), "sharded",
                                                   mesh=cpu4)
    with pytest.raises(ValueError, match="H % shards"):
        spec.compile((18, 16), "sharded", mesh=cpu4)
    with pytest.raises(ValueError, match="Hs >= r"):
        spec.compile((4, 16), "sharded", mesh=cpu4)
    with pytest.raises(ValueError, match="min_extent"):
        spec.compile((16, 2), "sharded", mesh=cpu4)
    with pytest.raises(TypeError, match="sequence of devices"):
        Mesh("cpu")
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    if not torch.cuda.is_available():       # a CUDA entry needs the card
        for kw in (dict(mesh=["cuda:0"] * 2), dict(mesh=cpu4, device="cuda")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                spec.compile((16, 16), "sharded", **kw)


def test_mesh_is_the_reference_shape_and_the_memo_key():
    """A mesh is a hashable tuple of devices, one shard each, and part of
    the memo key."""
    mesh = Mesh(["cpu", "cpu", torch.device("cpu")])
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert Mesh(["cpu"] * 3) == mesh and hash(Mesh(["cpu"] * 3)) == hash(mesh)
    spec = Filter2D(window=3)
    cf = spec.compile((12, 8), "sharded", mesh=["cpu"] * 3)
    assert cf is spec.compile((12, 8), "sharded", mesh=mesh, device="cpu")
    assert cf is not spec.compile((12, 8), "sharded", mesh=["cpu"] * 2)
    assert cf.device == torch.device("cpu") and cf.mesh == mesh
    assert cf.n_shards == 3


def test_auto_with_a_mesh_picks_the_ring(rng):
    x = to_torch(frame(rng, "float32", (12, 9)), "float32")
    k = coeffs(rng, "float32", (3, 3))
    spec = Filter2D(window=3)
    pipeline._compiled.cache_clear()      # compile events come once
    with obs.tracing():
        cf = spec.compile(x, mesh=["cpu"] * 3)
        picks = obs.events.events(kind="auto_select")
    assert cf.execution == "sharded" and cf.selection[0] == "mesh"
    assert [e.has_mesh for e in picks] == [True]
    with obs.tracing():
        spec.compile(x, device="cpu")
        assert [e.has_mesh for e in obs.events.events(kind="auto_select")
                ] == [False]
    torch.testing.assert_close(
        cf(x, k), spec.compile(x, "core", device="cpu")(x, k),
        rtol=F32_TOL, atol=F32_TOL)
    text = repr(cf) + cf.explain()
    assert "shards=3" in text and "3 row shards" in text
    assert f"{cf.wire_bytes} B" in text


SPECS = {
    "f32w5": dict(window=5),
    "f32w3dup": dict(window=3, border=("duplicate", 0.0)),
    "i8w3rq": dict(window=3, dtype="int8", border=("constant", 300.0),
                   requant=dict(rounding="nearest_even", dtype="int8")),
    "i16w5wrap": dict(window=5, dtype="int16", form="tree",
                      border=("wrap", 0.0)),
    "bf16w7": dict(window=7, dtype="bfloat16", form="compress"),
}


@pytest.mark.parametrize("shape", [(96, 128), (4, 1440, 1920, 1),
                                   (2, 60, 90, 3)])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_explain_equals_the_reference(name, shape):
    """spec, frame, geometry, vmem and hbm sections and the roofline's
    flops and bytes per pixel equal the reference's ``'sharded'`` report
    (its accounting does not depend on the mesh's size)."""
    kw = dict(SPECS[name])
    b = kw.pop("border", None)
    rq = kw.pop("requant", None)
    rspec = RFilter2D(**kw, border=RBorder(*b) if b else RBorder("mirror"),
                      requant=RRequant(**rq) if rq else None)
    spec, _, _ = from_reference(dataclasses.asdict(rspec), np.zeros(1))
    rmesh = RMesh(np.array(jax.devices()[:1]), ("data",))
    rd = rspec.compile(shape, "sharded", mesh=rmesh).explain(as_dict=True)
    d = spec.compile(shape, "sharded", mesh=["cpu"] * 4).explain(
        as_dict=True)
    for key in ("spec", "frame", "geometry", "vmem", "hbm"):
        assert d[key] == rd[key], (key, d[key], rd[key])
    for key in ("flops_per_pixel", "bytes_per_pixel"):
        assert d["roofline"][key] == rd["roofline"][key], key
    assert d["execution"]["executor"] == rd["execution"]["executor"]
    assert d["execution"]["rule"] == rd["execution"]["rule"]
    assert d["verify"] is None
