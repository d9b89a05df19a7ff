"""Port vs reference: the explicit data-parallel step with int8 error
feedback (``training/dp_shardmap.py``) and its collectives, on a CPU
``DeviceMesh`` of four entries.

The reference's own ``make_compressed_dp_step`` runs once per module in a
subprocess on 4 host devices (the host-platform device count must be set
before JAX starts, as in ``tests/test_multidevice.py``): tiny yi-6b, two
steps on a (pod 2, data 2) mesh, so that the residual carries, and two on
a (data 2, model 2) mesh, where nothing is compressed. Its reduction
alone runs there too: the lines of its ``reduce_leaf``
(``src/repro/training/dp_shardmap.py:58-66``) in a ``shard_map`` over
('pod',) on gradients and residuals made with numpy. Everything is
written to an ``.npz`` that the port's cases read.

Tolerances: the reduction fed equal inputs is bit-exact in ``q``, the
int32 sum and the new residuals (the residual in one rounding, as XLA
compiles the reference's jitted step: an FMA), and the result within 1
ulp. The whole step: loss within relative 1e-5, parameters and residuals
within 1e-4 absolute, after each of the two steps; the schedule's rate
exactly. One exception, stated as the router's near-tie is in
tests/test_torch_lm.py: the two packages' float32 gradients differ in
their last bits, so where ``(g + err) / scale`` lies at a rounding
halfway point ``q`` may differ by one. Such an element (within
``HALF_TOL`` of the halfway point, in units of the scale) may carry a
residual one scale apart and, AdamW normalising its gradient, a
parameter up to twice the summed rates apart; the test holds every
other element to 1e-4 and counts these (three of 345,216 over two steps
here).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.data import make_train_batch
from repro_torch.models import registry
from repro_torch.models.module import tree_paths
from repro_torch.optim import adamw_init
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.collectives import MeshValue
from repro_torch.sharding.mesh import make_mesh
from repro_torch.training.dp_shardmap import (init_error_feedback,
                                              make_compressed_dp_step,
                                              reduce_over_pod)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
HALF_TOL = 1e-3       # of a quantisation step: a halfway point
MAX_FLIPS = 16
MESHES = {"pd": ((2, 2), ("pod", "data")), "dm": ((2, 2), ("data", "model"))}
SEQ, BATCH, STEPS = 16, 8, 2
# leaves of the reduction case: shapes, and one whose g + err hits the
# halfway points (scale 1: max |g| = 127) to pin round-half-to-even
LEAVES = [(7, 5), (300,), (2, 3, 4), (6,), (4,)]

REFERENCE = """
import dataclasses, sys
sys.path[:0] = [%r]
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from _torch_parity import reference_bundle_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.data import make_train_batch
from repro.models import module, registry
from repro.optim import adamw_init
from repro.optim.compression import int8_ef_compress, int8_ef_decompress
from repro.training.dp_shardmap import (init_error_feedback,
                                        make_compressed_dp_step)
MESHES, LEAVES, (SEQ, BATCH, STEPS) = %r, %r, %r
out = {}
def flat(prefix, tree):
    for k, v in module.tree_paths(tree).items():
        out[prefix + "/".join(k)] = np.asarray(v)

# the reduction alone: reduce_leaf's lines in a shard_map over 'pod'
rng = np.random.default_rng(22)
pod = jax.make_mesh((2,), ("pod",))
def local(g, e):
    q, scale, new_e = int8_ef_compress(g[0], e[0])
    acc = jax.lax.psum(q.astype(jnp.int32), "pod")
    scale = jax.lax.pmax(scale, "pod")
    npod = jax.lax.psum(jnp.ones((), jnp.float32), "pod")
    g_out = int8_ef_decompress(acc, scale) / npod
    return q[None], acc[None], new_e[None], g_out[None]
red = jax.jit(shard_map(local, mesh=pod, in_specs=(P("pod"), P("pod")),
                        out_specs=P("pod"), check_rep=False))
for i, shape in enumerate(LEAVES):
    g = rng.standard_normal((2,) + shape).astype(np.float32)
    g[1] *= 40.0                      # the pods' scales far apart
    e = (rng.standard_normal((2,) + shape) * 0.01).astype(np.float32)
    if i == 3:
        g[:] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
        e[:] = 0.0
    if i == 4:
        g[:] = 0.0                    # the scale's floor
    out[f"red:g:{i}"], out[f"red:e:{i}"] = g, e
    for name, v in zip(("q", "acc", "ne", "out"), red(g, e)):
        out[f"red:{name}:{i}"] = np.asarray(v)

# the whole step
rc = RunConfig(model=tiny_of("yi_6b"),
               shape=dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                         global_batch=BATCH),
               mesh=SINGLE_POD,
               train=TrainConfig(loss_chunk=SEQ, remat_policy="none",
                                 warmup_steps=2, total_steps=20))
bundle = registry.build(rc)
params0 = reference_bundle_params(bundle, jax.random.key(0), jit=True)
flat("init:", params0)
for name, (shape, axes) in MESHES.items():
    mesh = jax.make_mesh(shape, axes)
    params, opt = params0, adamw_init(params0)
    err = init_error_feedback(params, mesh)
    step = make_compressed_dp_step(bundle, rc, mesh)
    for i in range(STEPS):
        params, opt, err, m = step(params, opt, err,
                                   make_train_batch(rc, i))
        for k, v in m.items():
            out[f"{name}:{i}:m:{k}"] = np.asarray(v)
        flat(f"{name}:{i}:p:", params)
        flat(f"{name}:{i}:e:", err)
np.savez(sys.argv[1], **out)
""" % (HERE, MESHES, LEAVES, (SEQ, BATCH, STEPS))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's reduction and steps, computed once for the module."""
    path = tmp_path_factory.mktemp("dp") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    out = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            d = out
            for seg in path:
                d = d.setdefault(seg, {})
            d[leaf] = v
    return out


def _rc():
    return RunConfig(model=tiny_of("yi_6b"),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=SEQ,
                                               global_batch=BATCH),
                     train=TrainConfig(loss_chunk=SEQ, remat_policy="none",
                                       warmup_steps=2, total_steps=20))


@pytest.mark.parametrize("i", range(len(LEAVES)))
def test_reduction_is_bit_exact(ref, i):
    """Each pod's q, the int32 sum and the new residuals equal the
    reference's bit for bit; the reduced gradient within 1 ulp."""
    pods = make_mesh((2,), ("pod",), ["cpu"] * 2)
    g, e = ref[f"red:g:{i}"], ref[f"red:e:{i}"]
    out, new_e, q, acc = reduce_over_pod(
        MeshValue(pods, {(p,): torch.from_numpy(g[p]) for p in (0, 1)}),
        MeshValue(pods, {(p,): torch.from_numpy(e[p]) for p in (0, 1)}))
    for p in (0, 1):
        assert q[(p,)].dtype == torch.int8 and acc[(p,)].dtype == torch.int32
        np.testing.assert_array_equal(q[(p,)].numpy(), ref[f"red:q:{i}"][p])
        np.testing.assert_array_equal(acc[(p,)].numpy(),
                                      ref[f"red:acc:{i}"][p])
        np.testing.assert_array_equal(new_e[(p,)].numpy(),
                                      ref[f"red:ne:{i}"][p])
        want = ref[f"red:out:{i}"][p]
        assert np.all(np.abs(out[(p,)].numpy() - want)
                      <= np.spacing(np.abs(want)))
    if i == 3:            # halfway points round to even, as jnp.round
        assert q[(0,)].tolist() == [127, 0, 2, 2, 0, -2]


def test_reduction_keeps_each_pods_own_scale_in_its_residual(ref):
    """The sum is dequantised by the larger scale; each pod's residual is
    against its own (the reference's quirk, kept)."""
    pods = make_mesh((2,), ("pod",), ["cpu"] * 2)
    g, e = ref["red:g:0"], ref["red:e:0"]
    gs = {(p,): torch.from_numpy(g[p]) for p in (0, 1)}
    es = {(p,): torch.from_numpy(e[p]) for p in (0, 1)}
    out, new_e, q, acc = reduce_over_pod(MeshValue(pods, gs),
                                         MeshValue(pods, es))
    scales = [float((gs[(p,)] + es[(p,)]).abs().max()) / 127 for p in (0, 1)]
    assert scales[1] > 10 * scales[0]
    gf = gs[(0,)] + es[(0,)]
    own = (gf.double() - q[(0,)].double() * float(gf.abs().max() / 127.0))
    torch.testing.assert_close(new_e[(0,)], own.float(), rtol=0, atol=0)
    shared = max(scales)
    np.testing.assert_allclose(out[(0,)].numpy(),
                               acc[(0,)].numpy() * shared / 2, rtol=1e-6)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_step_matches_reference(ref, mesh_name, monkeypatch):
    """Two steps of the port's step against the reference's own on the
    same mesh shape: (pod 2, data 2) compresses over 'pod' and carries
    the residual; (data 2, model 2) only takes the data mean, the
    residual stays zero. Elements whose ``q`` may flip at a halfway point
    are found from the port's own ``(g + err) / scale`` (module
    docstring)."""
    from repro_torch.training import dp_shardmap
    seen = []                 # per compress call: ((g + err) / scale, scale)
    compress = dp_shardmap.int8_ef_compress

    def recording(g, e, fma=False):
        q, scale, new_e = compress(g, e, fma=fma)
        seen.append(((g.float() + e) / scale).numpy().copy())
        seen.append(float(scale))
        return q, scale, new_e

    monkeypatch.setattr(dp_shardmap, "int8_ef_compress", recording)
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, ["cpu"] * 4)
    rc = _rc()
    bundle = registry.build(rc, device="cpu")
    params = params_from_reference(_tree(ref, "init:"), device="cpu")
    opt = adamw_init(params)
    err = init_error_feedback(params, mesh)
    step = make_compressed_dp_step(bundle, rc, mesh)
    keys = list(tree_paths(params_to_numpy(params)))
    flipped = {}              # path -> (bool mask, largest scale)
    lr_sum = 0.0
    for i in range(STEPS):
        del seen[:]
        params, opt, err, m = step(params, opt, err,
                                   make_train_batch(rc, i, "cpu"))
        pre = f"{mesh_name}:{i}:"
        np.testing.assert_allclose(float(m["loss"]), ref[pre + "m:loss"],
                                   rtol=LOSS_TOL)
        assert m["lr"] == float(ref[pre + "m:lr"])
        lr_sum += m["lr"]
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref[pre + "m:grad_norm"], rtol=1e-4)
        got_e = tree_paths(params_to_numpy(err))
        want_e = tree_paths(_tree(ref, pre + "e:"))
        assert len(seen) == (4 * len(keys) if mesh_name == "pd" else 0)
        for j, k in enumerate(keys):
            assert got_e[k].shape == want_e[k].shape
            bad = np.abs(got_e[k] - want_e[k]) > PARAM_TOL
            if not bad.any() and k not in flipped:
                continue
            u = np.stack([seen[4 * j], seen[4 * j + 2]])
            halfway = np.abs(np.abs(u - np.trunc(u)) - 0.5) <= HALF_TOL
            mask, top = flipped.get(k, (np.zeros_like(bad[0]), 0.0))
            new = bad & ~mask[None]
            assert not (new & ~halfway).any(), (k, i)
            top = max(top, seen[4 * j + 1], seen[4 * j + 3])
            mask = mask | new.any(0)
            flipped[k] = (mask, top)
            assert np.all(np.abs(got_e[k] - want_e[k])[:, mask]
                          <= 2 * top), k
        got = tree_paths(params_to_numpy(params))
        want = tree_paths(_tree(ref, pre + "p:"))
        assert got.keys() == want.keys()
        for k in want:
            d = np.abs(got[k] - want[k])
            mask = flipped.get(k, (np.zeros(d.shape, bool),))[0]
            assert np.all(d[~mask] <= PARAM_TOL), (k, float(d[~mask].max()))
            assert np.all(d[mask] <= 2 * lr_sum), k
        if mesh_name == "dm":
            assert all(not v.any() for v in got_e.values())
    assert sum(int(f[0].sum()) for f in flipped.values()) <= MAX_FLIPS


def test_residual_is_per_pod_and_float32():
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), ["cpu"] * 4)
    params = {"a": torch.ones(3, 4), "b": {"c": torch.ones(5,
                                                         dtype=torch.bfloat16)}}
    err = init_error_feedback(params, mesh)
    assert err["a"].shape == (2, 3, 4) and err["b"]["c"].shape == (2, 5)
    assert err["b"]["c"].dtype == torch.float32
    flat_mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    assert init_error_feedback(params, flat_mesh)["a"].shape == (1, 3, 4)


def test_batch_must_split_over_the_ranks():
    mesh = make_mesh((2, 2), ("pod", "data"), ["cpu"] * 4)
    rc = _rc()
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    step = make_compressed_dp_step(bundle, rc, mesh)
    batch = {k: v[:6] for k, v in make_train_batch(rc, 0, "cpu").items()}
    with pytest.raises(ValueError, match="does not split"):
        step(params, adamw_init(params), init_error_feedback(params, mesh),
             batch)


def test_collectives_on_a_mesh():
    """psum / pmean / pmax / ppermute / axis_index against their
    definitions on a (2, 3) mesh; ppermute fills zeros where nothing is
    sent, and autograd runs through psum and ppermute."""
    mesh = make_mesh((2, 3), ("pod", "data"), ["cpu"] * 6)
    base = {c: torch.tensor([float(c[0] * 10 + c[1]), -float(c[1])],
                            requires_grad=True) for c in mesh.coords()}
    v = MeshValue(mesh, base)
    s = coll.psum(v, "data")
    assert s[(1, 2)].tolist() == [33.0, -3.0]
    assert coll.pmean(v, "pod")[(0, 1)].tolist() == [6.0, -1.0]
    assert coll.pmax(v, "data")[(0, 0)].tolist() == [2.0, 0.0]
    assert coll.axis_index(mesh, "data")[(1, 2)] == 2
    sent = coll.ppermute(v, "data", [(0, 1), (1, 2)])
    assert sent[(1, 1)].tolist() == [10.0, 0.0]
    assert sent[(1, 0)].tolist() == [0.0, 0.0]
    # the gradient of data 0's value: once through its psum at (0, 0), and
    # once through the wire to (0, 1)
    (s[(0, 0)].sum() + sent[(0, 1)].sum()).backward()
    assert base[(0, 0)].grad.tolist() == [2.0, 2.0]
    assert base[(0, 1)].grad.tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="not a permutation"):
        coll.ppermute(v, "data", [(0, 1), (2, 1)])


def test_launcher_int8_ef_on_the_cpu(capsys):
    """``--mesh 2x2x1 --grad-compression int8_ef --device cpu``: the
    reference's loop on a (pod 2, data 2, model 1) mesh of CPU entries."""
    from repro_torch.launch import train
    train.main(["--arch", "yi_6b", "--tiny", "--steps", "2", "--seq", "16",
                "--batch", "4", "--mesh", "2x2x1", "--grad-compression",
                "int8_ef", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" loss ")[0] for ln in lines] == [
        "[train/int8_ef] step 0", "[train/int8_ef] step 1"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in lines)
