"""Port parity, the stencil engine: the PyTorch package's ``stencil_apply``
(on the CPU, where the kernels' plain versions run) against the JAX
reference's ``stencil_apply`` (Pallas in interpret mode) and ``stencil_ref``
on the same numpy inputs.

* integer-valued f64 data: bit-exact (every summation order is exact);
* random f32 data: within ``flops * sweeps * eps32 * (sum_taps |w|)**sweeps
  * max|a|`` of the f64 reference -- each of the plan's ``flops`` roundings
  per sweep is at most ``eps32`` of the largest magnitude any intermediate
  can reach, ``(sum_taps |w|)**sweeps * max|a|``;
* bf16 data: within one bf16 ulp of the f32-accumulated reference on the
  same (bf16-rounded) input -- the port casts its f32 result once -- plus
  the f32 bound above for the two sides' summation orders.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels import get_stencil as jget_stencil  # noqa: E402
from repro.kernels import spec_from_mask as jspec_from_mask  # noqa: E402
from repro.kernels import stencil_apply as japply  # noqa: E402
from repro.kernels import stencil_ref as jref  # noqa: E402
from repro.kernels.stencil_engine.spec import bc_labels  # noqa: E402
from repro_torch.kernels import (carry_over, compile_plan,  # noqa: E402
                                 get_stencil, stencil_apply, stencil_ref)
from repro_torch.kernels.stencil_engine import (autotune_engine,  # noqa: E402
                                                bytes_per_point,
                                                pick_block_rows)
from repro_torch.kernels.stencil_engine.autotune import (  # noqa: E402
    stream_smem_bytes)
from repro_torch.kernels.stencil_engine.common import (  # noqa: E402
    BLOCKS_PER_SM, NUM_SMS, SMEM_PER_BLOCK)

SHAPE3 = (2, 16, 12, 24)
SHAPE1 = (6, 40)
SPECS = {"stencil7": (4,), "stencil27": (2, 2, 2), "star13": (3,),
         "box125": (3, 3, 3), "stencil3": (2,)}
EPS32 = float(np.finfo(np.float32).eps)


def _shape(name):
    return SHAPE1 if name == "stencil3" else SHAPE3


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float64)


def _jref(a, w, stencil, sweeps):
    with jax.enable_x64(True):
        return np.asarray(jref(jax.numpy.asarray(a), jax.numpy.asarray(w),
                               stencil, sweeps=sweeps))


def _japply(a, w, stencil, sweeps, **kw):
    with jax.enable_x64(True):
        return np.asarray(japply(jax.numpy.asarray(a), jax.numpy.asarray(w),
                                 stencil, sweeps=sweeps, **kw))


def _tapply(a, w, stencil, sweeps, dtype=torch.float64, **kw):
    return stencil_apply(torch.tensor(a, dtype=dtype), torch.tensor(w),
                         stencil, sweeps=sweeps, **kw)


def _f32_tol(name, a, w, sweeps):
    spec = get_stencil(name)
    wflat = np.asarray(w).reshape(-1)
    sum_w = float(sum(abs(wflat[i]) for i in spec.w_index))
    flops = compile_plan(name).flops
    return flops * sweeps * EPS32 * sum_w ** sweeps * float(np.abs(a).max())


@pytest.mark.parametrize("sweeps", (1, 2, 3))
@pytest.mark.parametrize("name", list(SPECS))
def test_integer_f64_bit_exact_vs_reference(name, sweeps):
    a = _ints(10 + sweeps, _shape(name))
    w = _ints(20 + sweeps, SPECS[name])
    want = _jref(a, w, name, sweeps)
    got = _tapply(a, w, name, sweeps).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        stencil_ref(torch.tensor(a), torch.tensor(w), name, sweeps).numpy(),
        want)


# (name, sweeps, pinned block_i): one interpret-mode reference call each.
PINNED = [("stencil7", 1, 4), ("stencil27", 2, 8), ("star13", 3, 16),
          ("box125", 2, 4), ("stencil3", 3, 2)]


@pytest.mark.parametrize("name,sweeps,block_i", PINNED)
def test_integer_f64_bit_exact_vs_reference_kernel(name, sweeps, block_i):
    a = _ints(30, _shape(name))
    w = _ints(31, SPECS[name])
    want = _japply(a, w, name, sweeps, block_i=block_i)
    got = _tapply(a, w, name, sweeps, block_i=block_i).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sweeps", (1, 2, 3))
@pytest.mark.parametrize("name", list(SPECS))
def test_f32_within_derived_tolerance(name, sweeps):
    rng = np.random.default_rng(40 + sweeps)
    a = rng.standard_normal(_shape(name)).astype(np.float32)
    w = rng.standard_normal(SPECS[name]).astype(np.float32)
    want = _jref(a.astype(np.float64), w.astype(np.float64), name, sweeps)
    got = _tapply(a, w, name, sweeps, dtype=torch.float32)
    assert got.dtype == torch.float32
    tol = _f32_tol(name, a, w, sweeps)
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("sweeps", (1, 3))
@pytest.mark.parametrize("name", list(SPECS))
def test_bf16_within_one_ulp_of_f32_accumulation(name, sweeps):
    rng = np.random.default_rng(50 + sweeps)
    a_bf = torch.tensor(rng.standard_normal(_shape(name)),
                        dtype=torch.bfloat16)
    w = rng.standard_normal(SPECS[name]).astype(np.float32)
    a32 = a_bf.float().numpy()
    with jax.enable_x64(True):
        want = np.asarray(jref(jax.numpy.asarray(a32), jax.numpy.asarray(w),
                               name, sweeps=sweeps)).astype(np.float64)
    got = stencil_apply(a_bf, torch.tensor(w), name, sweeps=sweeps)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)      # bf16: 8 significand bits
    assert np.all(np.abs(got - want) <= ulp + _f32_tol(name, a32, w, sweeps))


def test_jacobi_run_matches_reference():
    """The slice as a whole: three chained ``stencil_apply(sweeps=2)``
    calls of stencil27, against the same run through the reference."""
    a = _ints(60, SHAPE3)
    w = np.array([[[2.0, -1.0], [1.0, 0.0]], [[-1.0, 1.0], [0.0, 1.0]]])
    ja, ta = a, torch.tensor(a)
    for _ in range(3):
        ja = _japply(ja, w, "stencil27", 2)
        ta = stencil_apply(ta, torch.tensor(w), "stencil27", sweeps=2)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert np.abs(ja).max() > 0


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_carry_over_ad_hoc_mask(seed):
    rng = np.random.default_rng(seed)
    shape = tuple(int(rng.choice([1, 3, 5])) for _ in range(3))
    mask = np.where(rng.random(shape) < 0.6,
                    np.arange(int(np.prod(shape))).reshape(shape), -1)
    mask[tuple(s // 2 for s in shape)] = int(np.prod(shape))
    _, inv = np.unique(mask[mask >= 0], return_inverse=True)
    mask[mask >= 0] = inv
    js = jspec_from_mask(f"adhoc{seed}", mask)
    fields = {"name": js.name, "ndim": js.ndim,
              "offsets": [list(o) for o in js.offsets],
              "w_index": list(js.w_index), "n_weights": js.n_weights,
              "w_shape": list(js.w_shape), "radius": list(js.radius),
              "bc": list(bc_labels(js.bc)), "coef": js.coef,
              "ordering": js.ordering}
    w = rng.integers(-2, 3, js.w_shape).astype(np.float64)
    ts, tw = carry_over(fields, w, device="cpu")
    assert (ts.offsets, ts.w_index, ts.radius, bc_labels(ts.bc)) == \
        (js.offsets, js.w_index, js.radius, bc_labels(js.bc))
    a = _ints(70 + seed, SHAPE3)
    want = _jref(a, w, js, 2)
    got = stencil_apply(torch.tensor(a), tw, ts, sweeps=2).numpy()
    np.testing.assert_array_equal(got, want)


# -- block choice -----------------------------------------------------------

def test_autotune_fills_the_card_within_shared_memory():
    path, bi, bj = autotune_engine(512, 512, 512, 4, plan=compile_plan(
        "stencil27"))
    assert path == "stream" and 512 % bi == 0
    assert stream_smem_bytes(bj, (1, 1, 1), 4) <= SMEM_PER_BLOCK
    blocks = -(-512 // 32) * -(-512 // bj) * (512 // bi)
    assert blocks >= BLOCKS_PER_SM * NUM_SMS
    # box125 in f64 still fits; a pinned block is kept
    _, bi2, bj2 = autotune_engine(40, 72, 100, 8, plan=compile_plan("box125"),
                                  sweeps=3, block_i=20)
    assert bi2 == 20
    assert stream_smem_bytes(bj2, (2, 2, 2), 8) <= SMEM_PER_BLOCK
    # one launch per sweep: the chooser's block_i covers the r_i lead-in
    # and does not depend on sweeps (the fused halo binds pinned blocks only)
    _, bi3, bj3 = autotune_engine(40, 72, 100, 4, plan=compile_plan("box125"),
                                  sweeps=3)
    assert bi3 >= 2 and 40 % bi3 == 0
    assert (bi3, bj3) == autotune_engine(40, 72, 100, 4, sweeps=1,
                                         plan=compile_plan("box125"))[1:]
    assert autotune_engine(512, 512, 512, 4, plan=compile_plan("stencil27"),
                           sweeps=64) == (path, bi, bj)


def test_chooser_blocks_take_more_sweeps_than_the_fused_halo():
    # sweeps * r_i = 5 exceeds M = 4: a pinned block_i is refused as in the
    # reference, chosen blocks run the chained sweeps
    a, w = _ints(84, (1, 4, 12, 24)), _ints(85, (4,)) % 2
    want = _jref(a, w, "stencil7", 5)
    got = stencil_apply(torch.tensor(a), torch.tensor(w), "stencil7",
                        sweeps=5)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exceed the carried halo"):
        stencil_apply(torch.tensor(a), torch.tensor(w), "stencil7",
                      sweeps=5, block_i=4)


def test_pick_block_rows_and_bytes_per_point():
    br = pick_block_rows(4096, 512, 4)
    assert 4096 % br == 0 and 4096 // br >= BLOCKS_PER_SM * NUM_SMS
    assert 2 * br * 512 * 4 <= SMEM_PER_BLOCK
    assert pick_block_rows(7, 100, 8) in (1, 7)
    assert bytes_per_point("stream", 4) == 8
    assert bytes_per_point("stream", 4, sweeps=2) == 8
    assert bytes_per_point("stream", 2, sweeps=2) == (4 + 8) / 2
    # the replicated path (ROADMAP A6, ported) fuses its sweeps
    assert bytes_per_point("replicate", 4, sweeps=2) == 4
    with pytest.raises(NotImplementedError, match="A7"):
        bytes_per_point("wavefront", 4)


# -- error paths ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(block_i=5),                       # does not divide M=16
    dict(block_i=1, sweeps=2),             # below the carried halo
    dict(block_i=4, block_j=5),            # does not divide N=12
    dict(block_i=4, block_j=1, sweeps=2),  # below the j halo
    dict(path="sideways"),                 # unknown path
    dict(sweeps=0),
])
def test_error_messages_match_reference(kw):
    a, w = _ints(80, SHAPE3), _ints(81, (2, 2, 2))
    sweeps = kw.pop("sweeps", 1)
    with pytest.raises(ValueError) as je:
        _japply(a, w, "stencil27", sweeps, **kw)
    with pytest.raises(ValueError) as te:
        _tapply(a, w, "stencil27", sweeps, **kw)
    assert str(te.value) == str(je.value)


def test_rows_block_message_matches_reference():
    a, w = _ints(82, SHAPE1), _ints(83, (2,))
    with pytest.raises(ValueError) as je:
        _japply(a, w, "stencil3", 1, block_i=4)
    with pytest.raises(ValueError) as te:
        _tapply(a, w, "stencil3", 1, block_i=4)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("stencil,kw,item", [
    ("stencil27_periodic", {}, "A5c"),
    ("stencil27_neumann", {}, "A5c"),
    ("stencil27_dirichlet", {}, "A5c"),
    ("stencil7", {"bc": "periodic"}, "A5c"),
    ("stencil3_periodic", {}, "A5c"),
    ("stencil27_redblack", {}, "A7"),
    ("stencil27", {"path": "replicate"}, "A6"),
    ("stencil27", {"guard": "nan"}, "A8"),
])
def test_out_of_slice_features_raise(stencil, kw, item):
    """What the port does not carry yet raises, naming its ROADMAP item;
    what later items ported (A5c boundaries, A6 the replicated path) now
    matches the reference."""
    shape = SHAPE1 if stencil.startswith("stencil3") else SHAPE3
    w = np.ones(get_stencil(stencil).w_shape)
    if item in ("A7", "A8"):
        with pytest.raises(NotImplementedError, match=item):
            stencil_apply(torch.zeros(shape), torch.tensor(w), stencil, **kw)
        if not kw:
            with pytest.raises(NotImplementedError, match=item):
                stencil_ref(torch.zeros(shape), torch.tensor(w), stencil)
        return
    a = _ints(90, shape)
    w = _ints(91, w.shape)
    with jax.enable_x64(True):
        want = np.asarray(jref(jax.numpy.asarray(a), jax.numpy.asarray(w),
                               stencil, bc=kw.get("bc")))
    got = stencil_apply(torch.tensor(a), torch.tensor(w), stencil, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if not kw:
        np.testing.assert_array_equal(
            stencil_ref(torch.tensor(a), torch.tensor(w), stencil).numpy(),
            want)


def test_variable_coefficients_raise():
    """Variable coefficients (ROADMAP A5d, ported) match the reference, and
    a coefficient array that does not cover the domain raises the
    reference's ValueError."""
    spec = get_stencil("stencil7").with_coef("var")
    jspec = jget_stencil("stencil7").with_coef("var")
    a = _ints(92, SHAPE3)
    w = _ints(93, (4,) + SHAPE3[1:])
    want = _jref(a, w, jspec, 2)
    got = stencil_apply(torch.tensor(a), torch.tensor(w), spec, sweeps=2)
    np.testing.assert_array_equal(got.numpy(), want)
    bad = np.ones((4, 3) + SHAPE3[2:])
    with pytest.raises(ValueError) as je:
        _jref(a, bad, jspec, 1)
    with pytest.raises(ValueError) as te:
        stencil_apply(torch.tensor(a), torch.tensor(bad), spec)
    assert str(te.value) == str(je.value)


def test_import_rules():
    """The port imports neither JAX nor the reference package."""
    code = ("import sys, repro_torch, repro_torch.kernels, "
            "repro_torch.kernels.stencil_engine, repro_torch.core, "
            "repro_torch.cuda_build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# -- kernel plumbing that runs without a card --------------------------------

def test_tap_table_layout():
    """The table the kernels read: the start of each di run, then
    (dj, dk, w_index) per tap in the spec's lexicographic order."""
    from repro_torch.kernels.stencil_engine.kernel import _tap_table
    spec = get_stencil("stencil7")
    tab = _tap_table(spec, torch.device("cpu")).tolist()
    assert tab[:4] == [0, 1, 6, 7]
    assert tab[4:] == [v for (_, dj, dk), wi in zip(spec.offsets,
                                                    spec.w_index)
                       for v in (dj, dk, wi)]
    assert _tap_table(get_stencil("stencil3"),
                      torch.device("cpu")).tolist()[:2] == [0, 3]


def test_wrappers_refuse_devices_without_a_kernel():
    from repro_torch.kernels.stencil_engine import (stencil_replicate,
                                                    stencil_stream)
    a = torch.zeros((1, 4, 4, 4), device="meta")
    for wrapper in (stencil_stream, stencil_replicate):
        with pytest.raises(ValueError, match="no kernel for device"):
            wrapper(a, torch.zeros(8, device="meta"),
                    compile_plan("stencil27"), 4, 8, 1)


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    from repro_torch import cuda_build
    src = tmp_path / "csrc" / "k.cu"
    src.parent.mkdir()
    src.write_text("// one\n")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    first = cuda_build._library_path(src)
    assert first.parent == tmp_path / "out"
    (src.parent / "k.cuh").write_text("// header\n")
    assert cuda_build._library_path(src) != first
