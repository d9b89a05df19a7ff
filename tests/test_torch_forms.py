"""Port vs reference over the full border × form × dtype grid: the port's
plain torch forms (``execution='core'``) and its kernel path
(``execution='cuda'``, which on a CPU tensor runs the kernel's plain
version ``filter2d_halo_ref``) against the reference's ``core`` executor,
on the same numpy inputs. The reference's Pallas path does not run on
this jax (ROADMAP R1), so its ``core`` executor — the oracle its own
kernel tests use — is the reference here."""
import dataclasses

import pytest

from repro.core.border_spec import BorderSpec as RBorder
from repro.core.pipeline import Filter2D as RFilter2D
from repro_torch.convert import from_reference

from _torch_parity import (DTYPES, FORMS, POLICIES, assert_match,
                           border_constant, coeffs, frame, to_jax, to_torch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("policy", POLICIES)
def test_forms_policies_dtypes(policy, form, dtype, rng):
    x = frame(rng, dtype, (13, 17))
    k = coeffs(rng, dtype, (3, 3))
    rspec = RFilter2D(window=3, form=form,
                      border=RBorder(policy, border_constant(dtype)),
                      dtype=dtype)
    xr = to_jax(x, dtype)
    ref = rspec.compile(xr, "core")(xr, k)
    spec, co, _ = from_reference(dataclasses.asdict(rspec), k)
    xt = to_torch(x, dtype)
    for execution in ("core", "cuda"):
        got = spec.compile(xt, execution, device="cpu")(xt, co)
        assert_match(got, ref, dtype, f"{execution} {policy} {form}")


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("w", [5, 7])
def test_wider_windows(w, policy, dtype, rng):
    x = frame(rng, dtype, (21, 30))
    k = coeffs(rng, dtype, (w, w))
    rspec = RFilter2D(window=w, form="tree",
                      border=RBorder(policy, border_constant(dtype)),
                      dtype=dtype)
    xr = to_jax(x, dtype)
    ref = rspec.compile(xr, "core")(xr, k)
    spec, co, _ = from_reference(dataclasses.asdict(rspec), k)
    xt = to_torch(x, dtype)
    for execution in ("core", "cuda"):
        got = spec.compile(xt, execution, device="cpu")(xt, co)
        assert_match(got, ref, dtype, f"{execution} w{w} {policy}")
