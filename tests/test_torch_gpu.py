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

from repro_torch.kernels.stencil_engine import (compile_plan, dirichlet,
                                                get_stencil, stencil_apply,
                                                stencil_replicate,
                                                stencil_replicate_plain,
                                                stencil_rows,
                                                stencil_rows_plain,
                                                stencil_stream,
                                                stencil_stream_plain)
from repro_torch.kernels.stencil_engine.autotune import replicate_tile
from repro_torch.kernels.stencil_engine.kernel import acc_dtype_for

pytestmark = pytest.mark.gpu

VOLUMETRIC = {"stencil7": (4,), "stencil27": (2, 2, 2), "star13": (3,),
              "box125": (3, 3, 3)}
# every kind of boundary, and a per-side mix
BCS = {"periodic": "periodic", "neumann": "neumann",
       "dirichlet0": dirichlet(0.0), "dirichlet2": dirichlet(2.0),
       "mix": (("periodic", "neumann", dirichlet(2.0)))}


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


def _spec(name, bc_key, coef="const"):
    spec = get_stencil(name)
    if bc_key != "clamp":
        spec = spec.with_bc(BCS[bc_key])
    return spec.with_coef(coef) if coef == "var" else spec


def _weights(seed, spec, shape, dtype, device):
    """Flat weights, or coefficient fields over the domain of ``shape``."""
    lead = (spec.n_weights,)
    if spec.coef == "var":
        lead += tuple(shape[-spec.ndim:])
    return _ints(seed, lead, acc_dtype_for(dtype), device, hi=1)


@pytest.mark.parametrize("coef", ("const", "var"))
@pytest.mark.parametrize("bc_key", list(BCS))
@pytest.mark.parametrize("name", ("stencil27", "star13"))
def test_stream_kernel_under_bcs(cuda, name, bc_key, coef):
    plan = compile_plan(_spec(name, bc_key, coef))
    for dtype in (torch.float64, torch.float32):
        for shape, blocks in (((2, 40, 72, 100), (6, 16)),
                              ((1, 4, 12, 24), (4, 64))):
            a = _ints(7, shape, dtype, cuda)
            w = _weights(8, plan.spec, shape, dtype, cuda)
            before = stencil_stream.launches
            got = stencil_stream(a, w, plan, *blocks, 2)
            assert stencil_stream.launches == before + 2
            assert torch.equal(got, stencil_stream_plain(a, w, plan, 2))


@pytest.mark.parametrize("coef", ("const", "var"))
@pytest.mark.parametrize("bc_key", ("clamp",) + tuple(BCS))
@pytest.mark.parametrize("name", ("stencil7", "stencil27", "star13"))
def test_replicate_kernel_matches_plain(cuda, name, bc_key, coef):
    """One launch fuses the sweeps (one per group where the tile cannot
    hold every sweep's halo, as with variable coefficients); tiles that do
    not divide the shape, a batch, and M = 4 at radius 2."""
    plan = compile_plan(_spec(name, bc_key, coef))
    spec = plan.spec
    n_var = spec.n_weights if coef == "var" else 0
    for dtype in (torch.float64, torch.float32):
        for shape, blocks in (((2, 40, 72, 100), (4, 16)),
                              ((1, 4, 12, 24), (1, 8))):
            a = _ints(9, shape, dtype, cuda)
            w = _weights(10, spec, shape, dtype, cuda)
            for sweeps in (1, 2, 3):
                group = replicate_tile(*shape[1:], a.element_size(), sweeps,
                                       spec.radius, n_var, *blocks)[3]
                before = stencil_replicate.launches
                got = stencil_replicate(a, w, plan, *blocks, sweeps)
                assert stencil_replicate.launches == before + -(-sweeps //
                                                                group)
                want = stencil_replicate_plain(a, w, plan, sweeps)
                assert torch.equal(got, want), (shape, sweeps, dtype)


def test_replicate_kernel_runs_sweeps_in_groups(cuda):
    """Past the halo one tile holds, the sweeps run in fused groups."""
    plan = compile_plan(_spec("stencil27", "periodic"))
    a = _ints(11, (1, 24, 40, 72), torch.float64, cuda, hi=1)
    w = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                     dtype=torch.float64, device=cuda)
    before = stencil_replicate.launches
    got = stencil_replicate(a, w, plan, 1, 8, 12)
    assert stencil_replicate.launches - before > 1
    assert torch.equal(got, stencil_replicate_plain(a, w, plan, 12))


def test_replicate_kernel_f32_random(cuda):
    plan = compile_plan(_spec("stencil27", "mix"))
    g = torch.Generator(device="cpu").manual_seed(12)
    a = torch.randn((2, 40, 72, 100), generator=g).to(cuda)
    w = torch.randn(plan.spec.n_weights, generator=g).to(cuda)
    got = stencil_replicate(a, w, plan, 4, 16, 3)
    want = stencil_replicate_plain(a.double(), w.double(), plan, 3)
    scale = float(w.abs()[list(plan.spec.w_index)].sum()) ** 3 * max(
        float(a.abs().max()), 2.0)
    tol = 2 * 3 * plan.spec.taps * torch.finfo(torch.float32).eps * scale
    assert float((got.double() - want).abs().max()) <= tol


@pytest.mark.parametrize("coef", ("const", "var"))
@pytest.mark.parametrize("bc_key", ("periodic", "neumann", "dirichlet2"))
def test_rows_kernel_under_k_bcs(cuda, bc_key, coef):
    spec = get_stencil("stencil3").with_bc(("clamp", "clamp",
                                            BCS[bc_key]))
    plan = compile_plan(spec.with_coef(coef) if coef == "var" else spec)
    for dtype in (torch.float64, torch.float32):
        a = _ints(13, (512, 300), dtype, cuda)
        w = _weights(14, plan.spec, a.shape, dtype, cuda)
        for sweeps in (1, 3):
            got = stencil_rows(a, w, plan, 4, sweeps)
            assert torch.equal(got, stencil_rows_plain(a, w, plan, sweeps))


def test_stencil_apply_numpy_input_runs_on_the_card(cuda):
    a = np.random.default_rng(15).integers(-2, 3, (1, 16, 12, 24)).astype(
        np.float64)
    w = np.ones(8)
    before = (stencil_stream.launches, stencil_replicate.launches)
    got = stencil_apply(a, w, "stencil27_periodic", sweeps=2)
    rep = stencil_apply(a, w, "stencil27_periodic", sweeps=2,
                        path="replicate")
    assert got.device.type == "cuda" and rep.device.type == "cuda"
    assert (stencil_stream.launches, stencil_replicate.launches) == (
        before[0] + 2, before[1] + 1)
    want = stencil_apply(torch.tensor(a), w, "stencil27_periodic", sweeps=2)
    assert torch.equal(got.cpu(), want) and torch.equal(rep.cpu(), want)
