"""Plan compiler: spec -> candidate pass pipelines -> cost model -> plan.

The package splits the former monolithic ``plan.py`` into the IR
(:mod:`.ir`: ops, liveness, the executor), the rewrite passes
(:mod:`.passes`: ``build_direct`` -> ``cse`` / ``mirror_factor`` ->
``unroll[k]`` -> ``order_ops``) and the cost model (:mod:`.cost`: lower a
plan onto the core PPC450 scheduler/simulator).  :func:`compile_plan` is
cost-driven: it enumerates candidate ``(pass_list, unroll)`` variants,
estimates cycles/point for each on the core machine model, and selects the
modeled-fastest -- the paper's synthesize -> simulate -> select loop, run at
plan-compile time.  The choice, its modeled cost, and the losing candidates
are recorded on the plan (``describe()['selection']``).

Three plan kinds (pass-list presets, ``PASS_PRESETS``):

``direct``
    ``[build_direct]`` -- the naive schedule, kept as an escape hatch for
    parity testing (54 shifts + 53 flop-ops for stencil27).  Always costed
    at ``unroll=1``; it is the baseline every selection must beat.

``cse``
    ``[build_direct, cse, order_ops]`` -- common-subexpression-eliminated
    schedule for arbitrary masks (10 + 53 for stencil27).

``factored``
    ``[build_direct, mirror_factor, order_ops]`` -- the paper's partial-sum
    factorization for mirror-symmetric specs at any radius (8 + 19 for
    stencil27, 12 + 19 for the radius-2 star13, 20 + 63 for box125; on
    variable-coefficient specs the pass partially factors -- unweighted
    pair sums stay shared, scales land at the output point).

``auto`` enumerates every kind valid for the spec; an explicit kind
enumerates its unroll ladder only.  Either way the resolved ``(kind,
unroll)`` is canonical *before* the memo lookup, so every alias spelling --
and ``auto`` vs its resolved kind -- shares one compiled plan object.  The
memo key is the canonical ``(spec, kind, unroll)`` triple; the spec hashes
on its full value including the coefficient kind, so variable- and
constant-coefficient variants never share an entry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

from ..spec import StencilSpec, get_stencil
from .cost import PlanCost, estimate_plan, fits_registers  # noqa: F401
from .ir import (Builder, PlanOp, StencilPlan, execute_plan,  # noqa: F401
                 op_sources, peak_live, renumber, shift_slice)
from .passes import (PASS_PRESETS, build_direct, cse,  # noqa: F401
                     mirror_factor, mirror_symmetric, order_ops,
                     preset_with_unroll, run_passes, unroll)

PLAN_KINDS = ("auto", "direct", "cse", "factored")

# The unroll ladder the compiler enumerates (paper sect. 4.2 explores the
# same small powers of two); candidates that overflow the FPR file are
# dropped by ``cost.fits_registers``.
UNROLL_CANDIDATES = (1, 2, 4)

_KIND_RANK = {"factored": 0, "cse": 1, "direct": 2}


def _valid_kinds(spec: StencilSpec) -> Tuple[str, ...]:
    if mirror_symmetric(spec):
        return ("direct", "cse", "factored")
    return ("direct", "cse")


@functools.lru_cache(maxsize=256)
def _cost_table(spec: StencilSpec
                ) -> Tuple[Tuple[str, int, PlanCost], ...]:
    """Every enumerated ``(kind, unroll) -> PlanCost`` row for one spec.

    ``direct`` is pinned at ``unroll=1`` (the untouched-naive baseline);
    the optimizing kinds walk ``UNROLL_CANDIDATES`` subject to the
    register-file guard.  Cached per spec so the table is computed once and
    shared by every request spelling.
    """
    rows = []
    for kind in _valid_kinds(spec):
        ladder = (1,) if kind == "direct" else UNROLL_CANDIDATES
        for u in ladder:
            plan = run_passes(spec, preset_with_unroll(kind, u))
            if u > 1 and not fits_registers(plan, u):
                continue
            rows.append((kind, u, estimate_plan(plan)))
    return tuple(rows)


def _select(spec: StencilSpec, kinds: Tuple[str, ...]) -> Tuple[str, int]:
    """The modeled-fastest ``(kind, unroll)`` among ``kinds``.

    Ties (to 1e-6 cycles) break toward the smaller unroll factor, then the
    more-factored kind -- deterministic, and stable under float noise in
    the simulator's steady-state differencing.
    """
    rows = [r for r in _cost_table(spec) if r[0] in kinds]
    best = min(rows, key=lambda r: (round(r[2].cycles_per_point, 6), r[1],
                                    _KIND_RANK[r[0]]))
    return best[0], best[1]


@functools.lru_cache(maxsize=256)
def _compile_plan_cached(spec: StencilSpec, kind: str,
                         unroll_factor: int) -> StencilPlan:
    """The memoized synthesis step, keyed on the *canonical* ``(spec, kind,
    unroll)`` triple -- a frozen spec hashes on its full value (taps,
    weight indices, radius, bc, coefficient kind), so repeated eager calls,
    the autotuner, and equal-valued ad-hoc ``spec_from_mask`` specs all
    share one compiled schedule, while variable- vs constant-coefficient
    specs and distinct unroll factors never collide."""
    plan = run_passes(spec, preset_with_unroll(kind, unroll_factor))
    table = _cost_table(spec)
    mine = next((c for k, u, c in table
                 if k == kind and u == unroll_factor), None)
    if mine is None:          # explicit unroll outside the enumerated ladder
        mine = estimate_plan(plan)
    return dataclasses.replace(
        plan, modeled=mine,
        candidates=tuple((k, u, c.cycles_per_point) for k, u, c in table))


def compile_plan(spec: Union[str, int, StencilSpec], plan: str = "auto",
                 unroll: Optional[int] = None) -> StencilPlan:
    """Compile ``spec`` into a :class:`StencilPlan` (memoized, cost-driven).

    ``plan="auto"`` enumerates every kind valid for the spec (``factored``
    only for mirror-symmetric tap sets) crossed with the unroll ladder, and
    selects the variant the core PPC450 model rates fastest; an explicit
    kind restricts the enumeration to that kind's unroll ladder, and an
    explicit ``unroll`` pins the factor (``direct`` stays pinned at 1 -- it
    is the untouched-naive baseline unless you ask otherwise).  The spec,
    kind, and unroll factor are canonicalized *before* the cache lookup, so
    ``compile_plan("27")``, ``compile_plan("stencil27")`` and
    ``compile_plan(get_stencil("stencil27"))`` -- and ``plan="auto"`` vs
    its resolved kind -- return the identical plan object.  The selection
    (chosen variant, modeled cycles/point, losing candidates) is recorded
    in ``describe()['selection']``.
    """
    spec = get_stencil(spec)
    if plan not in PLAN_KINDS:
        raise ValueError(f"unknown plan {plan!r}; expected one of {PLAN_KINDS}")
    if plan == "factored" and not mirror_symmetric(spec):
        raise ValueError(
            f"{spec.name}: factored plan needs a mirror-symmetric tap set "
            f"(closed under per-axis sign flips, weights on |offsets|); "
            f"use plan='cse' or 'auto'")
    kinds = _valid_kinds(spec) if plan == "auto" else (plan,)
    if unroll is not None:
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        if plan == "auto":
            rows = [r for r in _cost_table(spec) if r[1] == unroll] or None
            if rows:
                kind = min(rows, key=lambda r: (
                    round(r[2].cycles_per_point, 6),
                    _KIND_RANK[r[0]]))[0]
            else:
                kind, _ = _select(spec, kinds)
        else:
            kind = plan
        return _compile_plan_cached(spec, kind, unroll)
    kind, factor = _select(spec, kinds)
    return _compile_plan_cached(spec, kind, factor)
