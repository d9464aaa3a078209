"""Port parity, boundary conditions and variable coefficients: the PyTorch
package's ``stencil_apply`` (on the CPU, where the kernels' plain versions
run) and ``stencil_ref`` against the JAX reference's ``stencil_ref`` (and,
on two tiny cases, its ``stencil_apply(path="replicate")`` in interpret
mode), on the same numpy inputs under ``jax.enable_x64(True)``.

* integer-valued f64 data: bit-exact, for every BC on both volumetric
  paths (``stream``, ``replicate``);
* random f32 data: within ``flops * sweeps * eps32 * (sum_taps |w|)**sweeps
  * max(max|a|, |v|)`` of the f64 reference, ``v`` the dirichlet ghost
  value -- each of the plan's roundings per sweep is at most ``eps32`` of
  the largest magnitude any intermediate can reach, and a ghost holds
  ``v``.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.kernels import stencil27_ref as jstencil27_ref  # noqa: E402
from repro.kernels import stencil3_ref as jstencil3_ref  # noqa: E402
from repro.kernels import stencil7_ref as jstencil7_ref  # noqa: E402
from repro.kernels import stencil_apply as japply  # noqa: E402
from repro.kernels import stencil_ref as jref  # noqa: E402
from repro.kernels.stencil_engine import spec as jspec  # noqa: E402
from repro_torch.kernels import (compile_plan, dirichlet,  # noqa: E402
                                 get_stencil, spec_from_mask, stencil3,
                                 stencil7, stencil27, stencil_apply,
                                 stencil_ref)
from repro_torch.kernels.stencil_engine import (  # noqa: E402
    autotune_engine, bytes_per_point, replicate_tile)
from repro_torch.kernels.stencil_engine.autotune import (  # noqa: E402
    replicate_smem_bytes)
from repro_torch.kernels.stencil_engine.common import (  # noqa: E402
    SMEM_PER_BLOCK, STATIC_SMEM)

SHAPE3 = (2, 6, 7, 9)
WSHAPE = {"stencil7": (4,), "stencil27": (2, 2, 2), "star13": (3,),
          "stencil3": (2,)}
EPS32 = float(np.finfo(np.float32).eps)
# BC spellings on each side: the port's and the reference's
BCS = {"periodic": ("periodic", "periodic"),
       "neumann": ("neumann", "neumann"),
       "dirichlet0": (dirichlet(0.0), jspec.dirichlet(0.0)),
       "dirichlet2": (dirichlet(2.0), jspec.dirichlet(2.0))}
MIX = (("periodic", "neumann", dirichlet(2.0)),
       ("periodic", "neumann", jspec.dirichlet(2.0)))


def _ints(seed, shape, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float64)


def _tspec(name, bc=None, coef="const"):
    spec = get_stencil(name)
    spec = spec if bc is None else spec.with_bc(bc)
    return spec if coef == "const" else spec.with_coef(coef)


def _jspec(name, bc=None, coef="const"):
    spec = jspec.get_stencil(name)
    spec = spec if bc is None else spec.with_bc(bc)
    return spec if coef == "const" else spec.with_coef(coef)


def _jref(a, w, stencil, sweeps):
    with jax.enable_x64(True):
        return np.asarray(jref(jax.numpy.asarray(a), jax.numpy.asarray(w),
                               stencil, sweeps=sweeps))


@functools.lru_cache(maxsize=None)
def _case(name, bc_key, sweeps):
    """Inputs and the reference's answer, shared by both paths."""
    seed = 100 * sweeps + sorted(BCS).index(bc_key) + 10 * len(name)
    a = _ints(seed, SHAPE3)
    w = _ints(seed + 1, WSHAPE[name], -2, 3)
    return a, w, _jref(a, w, _jspec(name, BCS[bc_key][1]), sweeps)


def _tapply(a, w, stencil, sweeps=1, dtype=torch.float64, **kw):
    return stencil_apply(torch.tensor(a, dtype=dtype), torch.tensor(w),
                         stencil, sweeps=sweeps, **kw)


@pytest.mark.parametrize("sweeps", (1, 3))
@pytest.mark.parametrize("path", ("stream", "replicate"))
@pytest.mark.parametrize("name", ("stencil7", "stencil27", "star13"))
@pytest.mark.parametrize("bc_key", sorted(BCS))
def test_integer_f64_bit_exact_under_each_bc(bc_key, name, path, sweeps):
    a, w, want = _case(name, bc_key, sweeps)
    got = _tapply(a, w, name, sweeps, bc=BCS[bc_key][0], path=path)
    np.testing.assert_array_equal(got.numpy(), want)
    if path == "stream":
        np.testing.assert_array_equal(
            stencil_ref(torch.tensor(a), torch.tensor(w), name, sweeps,
                        bc=BCS[bc_key][0]).numpy(), want)


@pytest.mark.parametrize("path", ("stream", "replicate"))
@pytest.mark.parametrize("name", ("stencil27", "star13"))
def test_per_side_mix(name, path):
    """i periodic, j neumann, k dirichlet(2): one rule per axis, and
    corners where the later axis's constant wins."""
    a = _ints(200, SHAPE3)
    w = _ints(201, WSHAPE[name], -2, 3)
    want = _jref(a, w, _jspec(name, MIX[1]), 2)
    got = _tapply(a, w, name, 2, bc=MIX[0], path=path)
    np.testing.assert_array_equal(got.numpy(), want)
    # one-sided mixes: lo and hi sides differ on every axis
    bc = ((dirichlet(2.0), "neumann"), ("neumann", "clamp"),
          ("clamp", dirichlet(2.0)))
    jbc = ((jspec.dirichlet(2.0), "neumann"), ("neumann", "clamp"),
           ("clamp", jspec.dirichlet(2.0)))
    if name == "star13":       # radius 2 refuses v != 0 beside clamp
        bc = tuple(tuple("neumann" if s == "clamp" else s for s in ax)
                   for ax in bc)
        jbc = tuple(tuple("neumann" if s == "clamp" else s for s in ax)
                    for ax in jbc)
    want = _jref(a, w, _jspec(name, jbc), 2)
    got = _tapply(a, w, name, 2, bc=bc, path=path)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ("stream", "replicate"))
@pytest.mark.parametrize("bc_key", ("clamp", "periodic", "neumann",
                                    "dirichlet2"))
@pytest.mark.parametrize("name", ("stencil27", "star13"))
def test_variable_coefficients_bit_exact(name, bc_key, path):
    """Per-point coefficients, shared across the batch: a full field and a
    broadcast one."""
    spec_t = _tspec(name, None if bc_key == "clamp" else BCS[bc_key][0],
                    "var")
    spec_j = _jspec(name, None if bc_key == "clamp" else BCS[bc_key][1],
                    "var")
    n_w = spec_t.n_weights
    a = _ints(300, SHAPE3)
    for wshape in ((n_w,) + SHAPE3[1:], (n_w, 1, SHAPE3[2], 1)):
        w = _ints(301, wshape, -2, 3)
        want = _jref(a, w, spec_j, 2)
        got = _tapply(a, w, spec_t, 2, path=path)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("coef", ("const", "var"))
@pytest.mark.parametrize("bc_key", ("clamp", "periodic", "neumann",
                                    "dirichlet0", "dirichlet2"))
def test_k_only_stencil3_under_each_bc(bc_key, coef):
    t_bc = j_bc = None
    if bc_key != "clamp":
        t_bc = ("clamp", "clamp", BCS[bc_key][0])
        j_bc = ("clamp", "clamp", BCS[bc_key][1])
    spec_t = _tspec("stencil3", t_bc, coef)
    a = _ints(400, (3, 4, 10))
    w = _ints(401, (2, 10) if coef == "var" else (2,), -2, 3)
    want = _jref(a, w, _jspec("stencil3", j_bc, coef), 3)
    np.testing.assert_array_equal(_tapply(a, w, spec_t, 3).numpy(), want)
    np.testing.assert_array_equal(
        stencil_ref(torch.tensor(a), torch.tensor(w), spec_t, 3).numpy(),
        want)


@pytest.mark.parametrize("path", ("stream", "replicate"))
def test_batched_leading_dims(path):
    a = _ints(500, (2, 3, 5, 6, 8))
    w = _ints(501, (2, 2, 2), -2, 3)
    want = _jref(a, w, _jspec("stencil27", MIX[1]), 2)
    got = _tapply(a, w, "stencil27", 2, bc=MIX[0], path=path)
    assert got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ("stream", "replicate"))
@pytest.mark.parametrize("bc_key", ("periodic", "neumann"))
def test_radius2_on_four_planes(bc_key, path):
    """M = 4 at radius 2: a periodic i axis wraps the whole domain within
    two sweeps' halo; a neumann one mirrors half of it."""
    a = _ints(600, (1, 4, 6, 8))
    w = _ints(601, (3,), -2, 3)
    want = _jref(a, w, _jspec("star13", BCS[bc_key][1]), 3)
    got = _tapply(a, w, "star13", 3, bc=BCS[bc_key][0], path=path)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ("stream", "replicate"))
@pytest.mark.parametrize("name", ("stencil27", "star13"))
@pytest.mark.parametrize("bc_key", sorted(BCS))
def test_f32_within_derived_tolerance(bc_key, name, path):
    rng = np.random.default_rng(700 + len(name))
    a = rng.standard_normal(SHAPE3).astype(np.float32)
    w = rng.standard_normal(WSHAPE[name]).astype(np.float32)
    sweeps = 2
    want = _jref(a.astype(np.float64), w.astype(np.float64),
                 _jspec(name, BCS[bc_key][1]), sweeps)
    got = _tapply(a, w, name, sweeps, dtype=torch.float32,
                  bc=BCS[bc_key][0], path=path)
    assert got.dtype == torch.float32
    spec = get_stencil(name)
    wflat = w.reshape(-1)
    sum_w = float(sum(abs(wflat[i]) for i in spec.w_index))
    v = 2.0 if bc_key == "dirichlet2" else 0.0
    tol = (compile_plan(name).flops * sweeps * EPS32 * sum_w ** sweeps
           * max(float(np.abs(a).max()), v))
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    assert err <= tol, (err, tol)


# (name, bc, shape, block_i, block_j, sweeps): one interpret-mode run of the
# reference's replicated-halo kernel each, untiled and j-tiled.
REPLICATE_KERNEL = [
    ("stencil7", "periodic", (1, 4, 5, 8), 2, None, 2),
    ("stencil27", "neumann", (1, 4, 6, 8), 2, 3, 2),
]


@pytest.mark.parametrize("name,bc,shape,bi,bj,sweeps", REPLICATE_KERNEL)
def test_replicate_vs_reference_kernel(name, bc, shape, bi, bj, sweeps):
    a = _ints(800, shape)
    w = _ints(801, WSHAPE[name], -2, 3)
    with jax.enable_x64(True):
        want = np.asarray(japply(
            jax.numpy.asarray(a), jax.numpy.asarray(w), name, block_i=bi,
            block_j=bj, sweeps=sweeps, path="replicate", bc=bc,
            interpret=True))
    got = _tapply(a, w, name, sweeps, block_i=bi, block_j=bj,
                  path="replicate", bc=bc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(block_i=4),                       # does not divide M=6
    dict(block_i=1, sweeps=2),             # below the carried halo
    dict(block_i=3, block_j=5),            # does not divide N=7
    dict(block_i=6, block_j=1, sweeps=2),  # below the j halo
])
def test_pinned_replicate_block_messages_match_reference(kw):
    a, w = _ints(810, SHAPE3), _ints(811, (2, 2, 2))
    sweeps = kw.pop("sweeps", 1)
    with pytest.raises(ValueError) as je:
        with jax.enable_x64(True):
            japply(jax.numpy.asarray(a), jax.numpy.asarray(w), "stencil27",
                   sweeps=sweeps, path="replicate", bc="periodic",
                   interpret=True, **kw)
    with pytest.raises(ValueError) as te:
        _tapply(a, w, "stencil27", sweeps, path="replicate", bc="periodic",
                **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name,entry,jentry,shape", [
    ("stencil27", stencil27, jstencil27_ref, SHAPE3),
    ("stencil7", stencil7, jstencil7_ref, SHAPE3),
    ("stencil3", stencil3, jstencil3_ref, (5, 12)),
])
def test_legacy_entry_points_match_reference(name, entry, jentry, shape):
    a = _ints(900, shape)
    w = _ints(901, WSHAPE[name], -2, 3)
    with jax.enable_x64(True):
        want = np.asarray(jentry(jax.numpy.asarray(a), jax.numpy.asarray(w)))
    np.testing.assert_array_equal(entry(torch.tensor(a),
                                        torch.tensor(w)).numpy(), want)
    from repro_torch.kernels.stencil_engine import compat
    ref = getattr(compat, f"{name}_ref")
    np.testing.assert_array_equal(ref(torch.tensor(a),
                                      torch.tensor(w)).numpy(), want)
    blk = "block_rows" if name == "stencil3" else "block_i"
    np.testing.assert_array_equal(
        entry(torch.tensor(a), torch.tensor(w), **{blk: shape[-3 if name
              != "stencil3" else 0]}).numpy(), want)
    with pytest.raises(TypeError, match="unexpected keyword"):
        entry(torch.tensor(a), torch.tensor(w), block_k=2)


def test_non_tensor_input_goes_to_the_card(monkeypatch):
    """A numpy array or a list never runs on the CPU unasked: with no CUDA
    device the call raises; a CPU tensor still runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, w = _ints(1000, SHAPE3), _ints(1001, (2, 2, 2))
    for arg in (a, a.tolist()):
        with pytest.raises(RuntimeError, match="pass a CPU tensor"):
            stencil_apply(arg, w, "stencil27")
    got = stencil_apply(torch.tensor(a), w, "stencil27")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  _jref(a, w, "stencil27", 1))


def test_still_out_of_the_port_raise():
    """What the port does not carry yet names its ROADMAP item."""
    a = torch.zeros(SHAPE3)
    with pytest.raises(NotImplementedError, match="A7"):
        stencil_apply(a, np.ones(8), "stencil27_redblack")
    with pytest.raises(NotImplementedError, match="A8"):
        stencil_apply(a, np.ones(8), "stencil27", guard="oracle")
    mask = -np.ones((7, 1, 1), dtype=int)
    mask[0, 0, 0] = mask[3, 0, 0] = 0
    wide = spec_from_mask("wide_i", mask)
    assert wide.radius[0] == 3
    with pytest.raises(NotImplementedError, match="A5g"):
        stencil_apply(a, np.ones(1), wide)
    with pytest.raises(NotImplementedError, match="A5g"):
        stencil_ref(a, np.ones(1), wide)


def test_replicate_tile_fits_and_groups_sweeps():
    """The replicated-halo tile holds its widened copies in shared memory;
    where the tile cannot hold the halo of every sweep, sweeps run in the
    largest groups it holds."""
    limit = SMEM_PER_BLOCK - STATIC_SMEM

    def fits(tile, rad, group, size=4, n_var=0):
        return replicate_smem_bytes(tile, rad, group, size, n_var) <= limit

    for sweeps, rad in ((1, (1, 1, 1)), (4, (1, 1, 1)), (2, (2, 2, 2))):
        for size in (4, 8):
            ti, tj, tk, group = replicate_tile(512, 512, 512, size, sweeps,
                                               rad)
            assert group == sweeps and (ti, tj) == (4, 8)
            # the first sweep computes rows of two warps
            assert tk + 2 * rad[2] * (sweeps - 1) == 64
            assert fits((ti, tj, tk), rad, sweeps, size)
    for sweeps, rad in ((64, (1, 1, 1)), (4, (2, 2, 2))):
        ti, tj, tk, group = replicate_tile(512, 512, 512, 4, sweeps, rad)
        assert 1 < group < sweeps
        assert fits((ti, tj, tk), rad, group)
        assert not fits((ti, tj, max(tk - 2 * rad[2], 32)), rad, group + 1)
    # variable coefficients add a tile per weight; pinned blocks are kept
    _, _, _, g_var = replicate_tile(512, 512, 512, 4, 4, (1, 1, 1), 8)
    assert g_var < 4
    plan = compile_plan(_tspec("stencil27", coef="var"))
    path, bi, bj = autotune_engine(64, 48, 40, 4, sweeps=2, plan=plan,
                                   block_i=4, path="replicate")
    assert (path, bi) == ("replicate", 4)
    assert replicate_tile(64, 48, 40, 4, 2, (1, 1, 1), 8, 4,
                          bj)[:2] == (4, bj)
    # extents past the domain's are cut to it
    assert replicate_tile(2, 3, 20, 4, 1, (1, 1, 1)) == (2, 3, 20, 1)
    # box125 with 27 coefficient tiles in f64: only a tile below a warp's
    # width holds one sweep
    tile = replicate_tile(512, 512, 512, 8, 2, (2, 2, 2), 27)
    assert tile[3] == 1 and tile[2] < 32
    assert fits(tile[:3], (2, 2, 2), 1, 8, 27)
    with pytest.raises(ValueError, match="no tile"):
        replicate_tile(512, 512, 512, 8, 1, (2, 2, 2), 27, 64, 64)
    # auto keeps streaming, whatever the sweeps
    assert autotune_engine(64, 48, 40, 4, sweeps=4)[0] == "stream"


def test_bytes_per_point_by_path_and_coefficients():
    assert bytes_per_point("replicate", 4) == 8
    assert bytes_per_point("replicate", 4, sweeps=4) == 2
    assert bytes_per_point("replicate", 4, sweeps=4, group=2) == (8 + 8) / 4
    # B1 with variable coefficients: 2 * itemsize + n_weights * acc
    assert bytes_per_point("stream", 4, coef="var", n_weights=8) == 40
    assert bytes_per_point("stream", 8, sweeps=2, coef="var",
                           n_weights=8) == (16 + 16 + 2 * 64) / 2
    assert bytes_per_point("replicate", 2, sweeps=2, coef="var",
                           n_weights=8) == (4 + 32) / 2
    with pytest.raises(NotImplementedError, match="A7"):
        bytes_per_point("wavefront", 4)
