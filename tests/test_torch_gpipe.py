"""Port vs reference: the GPipe pipeline (``training/pipeline.py``) on a
CPU ``DeviceMesh`` of P 'stage' entries.

The reference's ``pipeline_apply`` / ``pipeline_loss_fn`` run once per
module in a subprocess on 4 host devices, each case inside ``with
jax.set_mesh(mesh):`` (jax 0.9 wants the caller's mesh context; nothing
of ``src/repro`` changes for it), for P in {1, 2, 4} stages and M in
{1, P, 2P} microbatches of 2 x 16: a tanh layer per stage, its forward,
a mean-square loss and the gradients of both stacked leaves. The port
runs the same numpy inputs.

Tolerances (float32): the forward within 1e-6 absolute, the gradients
within relative L2 1e-6 (the two libraries' matmuls sum in different
orders; the reference's own pipeline equals its unpipelined stack).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.sharding.mesh import make_mesh
from repro_torch.training.pipeline import pipeline_apply, pipeline_loss_fn

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = sorted({(P_, M) for P_ in (1, 2, 4) for M in (1, P_, 2 * P_)})
MB, D = 2, 16
FWD_TOL = 1e-6
GRAD_TOL = 1e-6

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.training.pipeline import pipeline_loss_fn
CASES, MB, D = %r, %r, %r
def layer(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])
def loss(o, t):
    return jnp.mean((o - t) ** 2)
out = {}
for P_, M in CASES:
    rng = np.random.default_rng(100 * P_ + M)
    w = (rng.standard_normal((P_, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((P_, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    y = rng.standard_normal((M, MB, D)).astype(np.float32)
    mesh = jax.make_mesh((P_,), ("stage",))
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    with jax.set_mesh(mesh):
        # the forward rides along as the loss's aux: one compile a case
        lf = pipeline_loss_fn(layer, lambda o, t: (loss(o, t), o), mesh)
        (val, fwd), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            params, jnp.asarray(x), jnp.asarray(y))
    key = f"{P_}-{M}"
    for name, v in (("w", w), ("b", b), ("x", x), ("y", y),
                    ("fwd", fwd), ("loss", val), ("gw", g["w"]),
                    ("gb", g["b"])):
        out[f"{key}:{name}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
""" % (CASES, MB, D)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case of the reference's pipeline, computed once."""
    path = tmp_path_factory.mktemp("gpipe") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(path) as z:
        return dict(z)


def _layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _loss(o, t):
    return ((o - t) ** 2).mean()


def _rl2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("P_,M", CASES)
def test_pipeline_matches_reference(ref, P_, M):
    key = f"{P_}-{M}"
    mesh = make_mesh((P_,), ("stage",), ["cpu"] * P_)
    w = torch.from_numpy(ref[key + ":w"]).requires_grad_(True)
    b = torch.from_numpy(ref[key + ":b"]).requires_grad_(True)
    x = torch.from_numpy(ref[key + ":x"])
    y = torch.from_numpy(ref[key + ":y"])
    params = {"w": w, "b": b}
    fwd = pipeline_apply(_layer, params, x, mesh)
    assert fwd.shape == (M, MB, D) and fwd.device == torch.device("cpu")
    np.testing.assert_allclose(fwd.detach().numpy(), ref[key + ":fwd"],
                               rtol=0, atol=FWD_TOL)
    val = pipeline_loss_fn(_layer, _loss, mesh)(params, x, y)
    np.testing.assert_allclose(float(val), ref[key + ":loss"], rtol=1e-6)
    gw, gb = torch.autograd.grad(val, [w, b])
    assert _rl2(gw.numpy(), ref[key + ":gw"]) <= GRAD_TOL
    assert _rl2(gb.numpy(), ref[key + ":gb"]) <= GRAD_TOL


@pytest.mark.parametrize("P_,M", [(4, 8), (2, 1)])
def test_stages_on_one_entry_count_each_gradient_once(P_, M):
    """Stages on repeated entries of one device: every stage's slice is a
    view of the stacked leaf and ``.to`` is no copy; the gradient equals
    the unpipelined stack's, not a multiple of it."""
    g = torch.Generator().manual_seed(P_ * 10 + M)
    w = (torch.randn(P_, D, D, generator=g) * 0.3).requires_grad_(True)
    b = (torch.randn(P_, D, generator=g) * 0.1).requires_grad_(True)
    x = torch.randn(M, MB, D, generator=g)
    y = torch.randn(M, MB, D, generator=g)
    mesh = make_mesh((P_,), ("stage",), ["cpu"] * P_)
    got = torch.autograd.grad(pipeline_loss_fn(_layer, _loss, mesh)(
        {"w": w, "b": b}, x, y), [w, b])
    h = x
    for s in range(P_):
        h = _layer({"w": w[s], "b": b[s]}, h)
    want = torch.autograd.grad(_loss(h, y), [w, b])
    for a, c in zip(got, want):
        assert _rl2(a.numpy(), c.numpy()) <= GRAD_TOL


def test_other_mesh_axes_run_on_their_first_coordinate():
    """A (stage 2, data 2) mesh: the schedule runs over 'stage' at data 0,
    and the result equals the 1-d mesh's."""
    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(2, D, D, generator=g) * 0.3,
              "b": torch.randn(2, D, generator=g) * 0.1}
    x = torch.randn(3, MB, D, generator=g)
    two = make_mesh((2, 2), ("stage", "data"), ["cpu"] * 4)
    one = make_mesh((2,), ("stage",), ["cpu"] * 2)
    torch.testing.assert_close(pipeline_apply(_layer, params, x, two),
                               pipeline_apply(_layer, params, x, one),
                               rtol=0, atol=0)
