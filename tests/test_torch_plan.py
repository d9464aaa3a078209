"""Port parity, registry and plans: the PyTorch package's spec registry,
plan compiler, cost model and PPC450 machine model against the JAX
reference.

For every registered name and a few random masks of radius <= 2, the port's
spec fields must equal the reference's, ``compile_plan`` must be op-for-op
identical (ops, out, unroll, passes, ``describe()``), and the modeled
cycles must be equal -- which also holds the port's dict-based dependency
DAG, scheduler and simulator to the reference's networkx-based ones.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import dag as jdag  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.kernels.stencil_engine import plan as jplan  # noqa: E402
from repro.kernels.stencil_engine import spec as jspec  # noqa: E402
from repro_torch.core import dag as tdag  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.kernels.stencil_engine import plan as tplan  # noqa: E402
from repro_torch.kernels.stencil_engine import spec as tspec  # noqa: E402

NAMES = sorted(jspec.list_stencils())


def _random_mask(seed: int) -> np.ndarray:
    """A random integer weight-index mask of radius <= 2 per axis, weights
    numbered 0..k-1 contiguously."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(rng.choice([1, 3, 5])) for _ in range(3))
    keep = rng.random(shape) < 0.5
    keep[tuple(s // 2 for s in shape)] = True
    nw = int(rng.integers(1, 6))
    idx = rng.integers(0, nw, shape)
    used = np.unique(idx[keep])
    remap = {int(u): i for i, u in enumerate(used)}
    return np.where(keep, np.vectorize(lambda v: remap.get(int(v), -1))(idx),
                    -1)


MASK_SEEDS = (1, 2, 3)


def _fields(spec):
    return (spec.name, spec.ndim, spec.offsets, spec.w_index, spec.n_weights,
            spec.w_shape, spec.radius, tspec.bc_labels(spec.bc)
            if isinstance(spec, tspec.StencilSpec) else
            jspec.bc_labels(spec.bc), spec.coef, spec.ordering, spec.guard)


def _ops(plan):
    return [(o.kind, o.a, o.b, o.off, o.w_idx) for o in plan.ops]


def _spec_pair(case):
    if isinstance(case, str):
        return jspec.get_stencil(case), tspec.get_stencil(case)
    mask = _random_mask(case)
    return (jspec.spec_from_mask(f"mask{case}", mask),
            tspec.spec_from_mask(f"mask{case}", mask))


def test_registry_names_match():
    assert sorted(tspec.list_stencils()) == NAMES


@pytest.mark.parametrize("case", NAMES + list(MASK_SEEDS), ids=str)
def test_spec_and_plan_parity(case):
    js, ts = _spec_pair(case)
    assert _fields(ts) == _fields(js)
    jp, tp = jplan.compile_plan(js), tplan.compile_plan(ts)
    assert _ops(tp) == _ops(jp)
    assert (tp.out, tp.unroll, tp.passes, tp.kind) == (jp.out, jp.unroll,
                                                      jp.passes, jp.kind)
    assert tp.describe() == jp.describe()
    assert tp.modeled.cycles_per_point == jp.modeled.cycles_per_point
    for (jk, ju, jc), (tk, tu, tc) in zip(jp.candidates, tp.candidates):
        assert (tk, tu, tc) == (jk, ju, jc)


@pytest.mark.parametrize("name,kind", [("stencil27", "direct"),
                                       ("star13", "cse"),
                                       ("box125", "factored")])
def test_dag_scheduler_parity(name, kind):
    """The dict-based DAG, priorities and greedy schedule of a lowered plan
    equal the reference's networkx-based ones, edge for edge."""
    from repro.kernels.stencil_engine.plan import cost as jcost
    from repro_torch.kernels.stencil_engine.plan import cost as tcost
    jp = jplan.compile_plan(name, kind)
    tp = tplan.compile_plan(name, kind)
    ji = jcost.lower_plan(jp, 2)
    ti = tcost.lower_plan(tp, 2)
    assert [(i.mnemonic, i.dest, i.srcs) for i in ti] == \
        [(i.mnemonic, i.dest, i.srcs) for i in ji]
    for war in (True, False):
        jg, tg = jdag.build_dag(ji, war=war), tdag.build_dag(ti, war=war)
        jedges = {(u, v): d["weight"] for u, v, d in jg.edges(data=True)}
        tedges = {(u, v): wt for u, succ in tg.succ.items()
                  for v, wt in succ.items()}
        assert tedges == jedges
        assert tdag.path_to_sink(tg) == jdag.path_to_sink(jg)
        assert tdag.critical_path_length(tg) == jdag.critical_path_length(jg)
        assert tdag.lower_bound(ti, tg) == jdag.lower_bound(ji, jg)
        js, ts = jsched.greedy_schedule(ji, jg), tsched.greedy_schedule(ti, tg)
        assert (ts.order, ts.issue_cycle, ts.makespan, ts.lower_bound) == \
            (js.order, js.issue_cycle, js.makespan, js.lower_bound)


def test_canon_weights_torch_and_numpy():
    import torch
    spec = tspec.get_stencil("stencil27")
    w = np.arange(8.0).reshape(2, 2, 2)
    assert isinstance(spec.canon_weights(w), np.ndarray)
    t = spec.canon_weights(torch.from_numpy(w))
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (8,)
    np.testing.assert_array_equal(t.numpy(), w.reshape(-1))
    with pytest.raises(ValueError, match="incompatible"):
        spec.canon_weights(np.ones(3))
