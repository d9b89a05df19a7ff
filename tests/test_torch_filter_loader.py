"""The ``filter2d_halo`` wrapper's host-side rules, on CPU tensors: which
loader a frame takes (TMA or per-thread: a function of shape, dtype and
address only) and what the kernel refuses before any launch
(``check_operands``, which the wrapper runs on every CUDA call). The
kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K

DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.uint8,
          torch.int16)
SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1, torch.uint8: 1,
        torch.int16: 2}


def _planes(dtype, shape, offset=0):
    """Contiguous [M, H, W] planes starting ``offset`` elements into a
    fresh allocation (the allocator's own alignment is 64 bytes)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + offset, dtype=dtype)
    assert flat.data_ptr() % 64 == 0
    return flat[offset:].view(shape)


@pytest.mark.parametrize("W", [1, 4, 8, 16, 48, 70, 301, 336, 1440, 1920])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_loader_follows_the_row_pitch(dtype, W):
    x = _planes(dtype, (2, 9, W))
    want = "tma" if W * SIZE[dtype] % 16 == 0 else "thread"
    assert K.loader_for(x) == want


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_loader_follows_the_first_element(dtype, offset):
    """A view with a storage offset: TMA only when its first element sits
    on a 16-byte boundary (the row pitch, 336 columns, always allows it)."""
    x = _planes(dtype, (2, 9, 336), offset)
    assert x.is_contiguous() and x.storage_offset() == offset
    want = "tma" if offset * SIZE[dtype] % 16 == 0 else "thread"
    assert K.loader_for(x) == want


def test_loader_ignores_everything_but_the_frame():
    """Same frame, same answer: the plane count, the values and the
    policy do not enter the rule."""
    for M in (1, 3, 7):
        assert K.loader_for(_planes(torch.float32, (M, 5, 48))) == "tma"
        assert K.loader_for(_planes(torch.float32, (M, 5, 47))) == "thread"
    x = torch.randn(2, 5, 48)
    assert K.loader_for(x) == K.loader_for(x.clone()) == "tma"


def _operands(dtype=torch.float32, shape=(2, 20, 48), w=5, n=2,
              form="direct", policy="mirror", rounding=None):
    x = _planes(dtype, shape)
    integer = not dtype.is_floating_point
    cdt = torch.int32 if integer else torch.float32
    co = torch.ones((n, 2, w) if form == "separable" else (n, w, w),
                    dtype=cdt)
    rq = q = None
    if integer and rounding is not None:
        name = str(dtype).split(".")[-1]
        rq = RequantSpec(rounding=rounding, dtype=name)
        q = torch.tensor([[1, 0]] * n, dtype=torch.int32)
    plan = halo.make_plan(shape[1], shape[2], w, BorderSpec(policy),
                          shape[1], shape[2],
                          dtype=str(dtype).split(".")[-1], requant=rq)
    return x, co, plan, q, form


@pytest.mark.parametrize("form", K.FORMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_check_accepts_what_the_kernel_takes(dtype, form):
    integer = not dtype.is_floating_point
    n = 1 if form == "separable" else 3
    K.check_operands(*_operands(dtype, n=n, form=form,
                                rounding="nearest" if integer else None))


def _bad_cases():
    """name -> (error, message pattern, check_operands arguments)."""
    x, co, plan, q, form = _operands()
    xi, coi, plani, qi, _ = _operands(torch.int8, rounding="nearest")
    gains = torch.ones(2, 2, dtype=torch.int32)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    planes, coeffs, windows = ("planes must be", "coeffs must be",
                               "match the plan")
    return {
        "float64 planes": (TypeError, "planes", (x.double(), co, plan, q,
                                                 form)),
        "int32 planes": (TypeError, "planes", (x.int(), co, plan, q, form)),
        "2-D planes": (ValueError, planes, (x[0], co, plan, q, form)),
        "strided planes": (ValueError, planes, (strided, co, plan, q, form)),
        "plan for another frame": (ValueError, "plan is for",
                                   (x[:, :10].contiguous(), co, plan, q,
                                    form)),
        "window 9": (ValueError, windows, (x, torch.ones(2, 9, 9), plan, q,
                                           form)),
        "window off the plan": (ValueError, windows,
                                (x, torch.ones(2, 3, 3), plan, q, form)),
        "float64 coeffs": (ValueError, coeffs, (x, co.double(), plan, q,
                                                form)),
        "separable taps as a square": (ValueError, coeffs,
                                       (x, co, plan, q, "separable")),
        "float coeffs on an int frame": (ValueError, coeffs,
                                         (xi, coi.float(), plani, qi, form)),
        "gains of the wrong shape": (ValueError, "q_params must be",
                                     (xi, coi, plani, qi[:1], form)),
        "gains of the wrong dtype": (ValueError, "q_params must be",
                                     (xi, coi, plani, qi.long(), form)),
        "gains without a requant plan": (ValueError, "no requant",
                                         (x, co, plan, gains, form)),
        "coeffs on another device": (ValueError, coeffs,
                                     (x, co.to("meta"), plan, q, form)),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_check_refuses_what_the_kernel_does_not_take(case):
    err, match, args = _bad_cases()[case]
    with pytest.raises(err, match=match):
        K.check_operands(*args)


def test_cpu_calls_leave_both_counts_alone():
    x, co, plan, q, form = _operands()
    before = (K.filter2d_halo.launches, K.filter2d_halo.tma_launches)
    y = K.filter2d_halo(x, co, plan, q_params=q, form=form)
    assert (K.filter2d_halo.launches, K.filter2d_halo.tma_launches) == before
    torch.testing.assert_close(y, K.filter2d_halo_ref(x, co, plan))
