"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device, and the
fixture skips where there is no CUDA device.  On a machine with an H100 and
the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Integer-valued data makes every summation order exact, so the kernels
(which evaluate the taps directly) must equal the plain versions (which
walk the compiled plan) exactly in f64, f32 and bf16; random f32 data
agrees within the f32 rounding of the two summation orders.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.stencil_engine import (compile_plan, stencil_apply,
                                                stencil_rows,
                                                stencil_rows_plain,
                                                stencil_stream,
                                                stencil_stream_plain)
from repro_torch.kernels.stencil_engine.kernel import acc_dtype_for

pytestmark = pytest.mark.gpu

VOLUMETRIC = {"stencil7": (4,), "stencil27": (2, 2, 2), "star13": (3,),
              "box125": (3, 3, 3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _ints(seed, shape, dtype, device, hi=2):
    """Integers in [-hi, hi]: with weights in [-1, 1], box125's three sweeps
    stay below 2**24, exact in f32."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(-hi, hi + 1, shape), dtype=dtype,
                        device=device)


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.bfloat16))
@pytest.mark.parametrize("sweeps", (1, 2, 3))
@pytest.mark.parametrize("name", list(VOLUMETRIC))
def test_stream_kernel_matches_plain_on_integers(cuda, name, sweeps, dtype):
    plan = compile_plan(name)
    for shape, blocks in (((1, 16, 12, 24), (8, 8)),
                          ((2, 40, 72, 100), (20, 16)),
                          ((2, 40, 72, 100), (6, 64))):
        a = _ints(1, shape, dtype, cuda)
        w = _ints(2, VOLUMETRIC[name], acc_dtype_for(dtype), cuda,
                  hi=1).reshape(-1)
        before = stencil_stream.launches
        got = stencil_stream(a, w, plan, *blocks, sweeps)
        assert stencil_stream.launches == before + sweeps
        want = stencil_stream_plain(a, w, plan, sweeps)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ("stencil27", "box125"))
def test_stream_kernel_f32_random(cuda, name):
    plan = compile_plan(name)
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn((2, 40, 72, 100), generator=g).to(cuda)
    w = torch.randn(plan.spec.n_weights, generator=g).to(cuda)
    got = stencil_stream(a, w, plan, 8, 16, 2)
    want = stencil_stream_plain(a.double(), w.double(), plan, 2)
    scale = float(w.abs()[list(plan.spec.w_index)].sum()) ** 2 * float(
        a.abs().max())
    tol = 2 * 2 * plan.spec.taps * torch.finfo(torch.float32).eps * scale
    assert float((got.double() - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.bfloat16))
def test_rows_kernel_matches_plain(cuda, dtype):
    plan = compile_plan("stencil3")
    a = _ints(4, (4096, 512), dtype, cuda)
    w = torch.tensor([1.0, -2.0], dtype=acc_dtype_for(dtype), device=cuda)
    for sweeps in (1, 3):
        before = stencil_rows.launches
        got = stencil_rows(a, w, plan, 4, sweeps)
        assert stencil_rows.launches == before + 1
        assert torch.equal(got, stencil_rows_plain(a, w, plan, sweeps))


def test_rows_kernel_refuses_rows_past_shared_memory(cuda):
    plan = compile_plan("stencil3")
    a = torch.zeros((2, 40_000), device=cuda)
    w = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        stencil_rows(a, w, plan, 1, 1)


def test_stencil_apply_runs_the_kernels(cuda):
    a = _ints(5, (2, 32, 24, 40), torch.float64, cuda)
    w = _ints(6, (2, 2, 2), torch.float64, cuda)
    before = stencil_stream.launches
    got = stencil_apply(a, w, "stencil27", sweeps=2)
    assert stencil_stream.launches == before + 2
    assert torch.equal(got.cpu(), stencil_apply(a.cpu(), w.cpu(),
                                                "stencil27", sweeps=2))
    before = stencil_rows.launches
    rows = stencil_apply(a, torch.tensor([1.0, 1.0]), "stencil3", sweeps=2)
    assert stencil_rows.launches == before + 1
    assert torch.equal(rows.cpu(), stencil_apply(
        a.cpu(), torch.tensor([1.0, 1.0]), "stencil3", sweeps=2))
