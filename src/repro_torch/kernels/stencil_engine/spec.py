"""Stencil specifications: radius-R coefficient masks + the named registry.

A :class:`StencilSpec` describes a stencil as a list of taps -- ``(di, dj,
dk)`` offsets in lexicographic order -- each tagged with an index into a flat
vector of unique coefficients, plus a per-axis ``radius`` bounding the
offsets.  The paper's three streaming kernels (3-, 7-, 27-point, sect. 3.1)
are radius-1 entries in the registry; high-order operators (the 4th-order
13-point star, the 5x5x5 box) are radius-2 entries, and any other operator is
one :func:`spec_from_mask` call away from an odd-shaped coefficient mask.
The spec is a frozen (hashable) dataclass, so it keys the plan memo and the
kernels' tap tables.  This module is the port's copy of the reference
package's ``spec.py``: the registry matches it name for name and field for
field, so a spec built on either side compiles to the same plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple, Union

import numpy as np
import torch

Offset = Tuple[int, int, int]
Radius = Tuple[int, int, int]

BC_KINDS = ("clamp", "periodic", "dirichlet", "neumann")
COEF_KINDS = ("const", "var")
ORDERING_KINDS = ("jacobi", "redblack")
# Guarded-execution spellings a spec may carry ("off" is the default; the
# other levels belong to guarded execution, not ported yet).
GUARD_KINDS = ("off", "nan", "invariant", "oracle", "full")


@dataclasses.dataclass(frozen=True)
class BC:
    """One boundary condition on one side of one axis.

    ``clamp``
        The engine's historical semantics (and the default): out-of-domain
        reads are zeros and the one-point boundary ring of the *output* is
        zeroed every sweep -- a homogeneous-Dirichlet solve where the ring
        itself is the held boundary.
    ``periodic``
        Out-of-domain reads wrap around the axis (``np.pad`` mode
        ``"wrap"``); the operator is applied at every point.  Must be paired
        -- periodic on one side of an axis requires periodic on the other.
    ``dirichlet``
        Out-of-domain (ghost) reads are the constant ``value`` (``np.pad``
        mode ``"constant"``); the operator is applied at every point.
    ``neumann``
        Zero-flux: out-of-domain reads mirror the domain edge-inclusively
        (ghost ``u[-1-q] = u[q]``; ``np.pad`` mode ``"symmetric"``); the
        operator is applied at every point.
    """

    kind: str
    value: float = 0.0            # dirichlet ghost value; ignored otherwise

    def __post_init__(self):
        if self.kind not in BC_KINDS:
            raise ValueError(f"unknown BC kind {self.kind!r}; expected one "
                             f"of {BC_KINDS}")
        if self.kind != "dirichlet" and self.value != 0.0:
            raise ValueError(f"BC value is only meaningful for dirichlet, "
                             f"got {self.kind}({self.value})")

    def label(self) -> str:
        if self.kind == "dirichlet":
            return f"dirichlet({self.value:g})"
        return self.kind


CLAMP = BC("clamp")
PERIODIC = BC("periodic")
NEUMANN = BC("neumann")


def dirichlet(value: float = 0.0) -> BC:
    """The constant-ghost boundary condition ``u_ghost = value``."""
    return BC("dirichlet", float(value))


# (lo, hi) per axis, axes in (i, j, k) order.
Boundary = Tuple[Tuple[BC, BC], Tuple[BC, BC], Tuple[BC, BC]]

CLAMP_ALL: Boundary = ((CLAMP, CLAMP), (CLAMP, CLAMP), (CLAMP, CLAMP))


def _as_bc(x) -> BC:
    if isinstance(x, BC):
        return x
    if isinstance(x, str):
        return BC(x)
    raise TypeError(f"cannot interpret {x!r} as a BC (use a kind string, a "
                    f"BC, or dirichlet(value))")


def _as_axis_bc(x) -> Tuple[BC, BC]:
    if isinstance(x, (BC, str)):
        b = _as_bc(x)
        return (b, b)
    if isinstance(x, (tuple, list)) and len(x) == 2:
        return (_as_bc(x[0]), _as_bc(x[1]))
    raise TypeError(f"cannot interpret {x!r} as a per-axis BC (use one "
                    f"kind/BC for both sides or a (lo, hi) pair)")


def as_boundary(bc) -> Boundary:
    """Canonicalize a boundary-condition spelling to the per-axis-side form.

    Accepts ``None`` (all clamp, the default), one kind string or :class:`BC`
    (applied to every side), or a 3-sequence of per-axis entries where each
    entry is itself a kind/:class:`BC` (both sides) or a ``(lo, hi)`` pair.
    The result is a hashable nested tuple, so a spec carrying it stays
    hashable.
    """
    if bc is None:
        return CLAMP_ALL
    if isinstance(bc, (BC, str)):
        b = _as_bc(bc)
        return ((b, b), (b, b), (b, b))
    if isinstance(bc, (tuple, list)) and len(bc) == 3:
        return tuple(_as_axis_bc(ax) for ax in bc)  # type: ignore[return-value]
    raise TypeError(f"cannot interpret {bc!r} as boundary conditions (use a "
                    f"kind, a BC, or 3 per-axis entries)")


def _validate_boundary(bc: Boundary, ndim: int,
                       radius: Radius = (1, 1, 1)) -> None:
    for ax, (lo, hi) in enumerate(bc):
        if (lo.kind == "periodic") != (hi.kind == "periodic"):
            raise ValueError(
                f"axis {ax}: periodic must be paired -- lo={lo.label()} "
                f"hi={hi.label()} (a one-sided wrap has no meaning)")
    if ndim == 1 and any(s.kind != "clamp" for ax in bc[:2] for s in ax):
        raise ValueError("ndim=1 specs may only carry k-axis boundary "
                         "conditions; i/j sides must stay clamp")
    values = {s.value for ax in bc for s in ax if s.kind == "dirichlet"}
    if len(values) > 1:
        raise ValueError(
            f"multiple distinct dirichlet values {sorted(values)}: corner "
            f"ghost cells would depend on the plan's shift order; use one "
            f"value for every dirichlet side")
    # A nonzero dirichlet ghost value is realized by linearity
    # (``stencil(u) = stencil(u - v) + v * sum(w)``, ghosts of the offset
    # field all zero) -- which requires every *other* ghost kind to be zero
    # under the offset too.  Clamp ghosts stay raw zeros (offset ghost
    # ``-v``), so any point that genuinely reads a clamp ghost -- an
    # interior point at distance >= 2 from a radius->=2 clamp edge -- would
    # be off by ``v * w``.  At radius 1 clamp ghosts only feed ring-masked
    # outputs, so the mix is well-defined there (and dirichlet(0) always
    # agrees with clamp's zero ghosts).
    if any(v != 0.0 for v in values):
        for ax, sides in enumerate(bc):
            if radius[ax] >= 2 and any(s.kind == "clamp" for s in sides):
                raise ValueError(
                    f"dirichlet with a nonzero ghost value cannot combine "
                    f"with a clamp side on a radius-{radius[ax]} axis "
                    f"(axis {ax}): clamp ghosts stay zero under the "
                    f"dirichlet offset identity and are genuinely read at "
                    f"radius >= 2; use dirichlet(0) or a non-clamp BC on "
                    f"that axis")


def bc_labels(bc: Boundary) -> Tuple[str, str, str]:
    """Compact per-axis labels (``describe()`` / benchmark form)."""
    return tuple(lo.label() if lo == hi else f"{lo.label()}|{hi.label()}"
                 for lo, hi in bc)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A radius-``(ri, rj, rk)`` stencil: taps in lexicographic ``(di, dj,
    dk)`` order.

    ``ndim == 3`` operates on ``(..., M, N, P)`` volumes with an i-direction
    halo; ``ndim == 1`` has k-only taps and operates on ``(..., P)`` rows
    (every leading dim is an independent row -- the paper's 3-point kernel).
    ``radius`` bounds per-axis offsets (``|di| <= ri`` etc.) and drives every
    geometry decision downstream: the streaming kernel's shared-memory
    window holds ``2 * ri + 1`` planes of a tile widened by ``rj``/``rk``
    per side.  ``bc`` is the per-axis-
    side boundary condition (:class:`BC`; default all-clamp, the historical
    semantics) -- part of the frozen spec, so plan memoization and
    ``describe()`` all distinguish BC variants for free.
    """

    name: str
    ndim: int                        # 3 (volumetric) or 1 (k-only rows)
    offsets: Tuple[Offset, ...]      # lexicographic tap order
    w_index: Tuple[int, ...]         # per-tap index into the flat weights
    n_weights: int                   # number of unique coefficients
    w_shape: Tuple[int, ...]         # user-facing weight array shape
    radius: Radius = (1, 1, 1)       # per-axis (ri, rj, rk) offset bound
    bc: Boundary = CLAMP_ALL         # per-axis (lo, hi) boundary conditions
    coef: str = "const"              # "const" scalars | "var" per-point arrays
    ordering: str = "jacobi"         # "jacobi" | "redblack" sweep ordering
    guard: str = "off"               # runtime-verification level (GUARD_KINDS)

    @property
    def taps(self) -> int:
        return len(self.offsets)

    @property
    def sweep_apps(self) -> int:
        """Operator applications per sweep: 1 for Jacobi, 2 for red-black
        Gauss-Seidel (red half-update then black half-update).  Every halo
        computation downstream scales by this -- the black half reads the
        red-updated field, so one red-black sweep propagates information
        ``2 * radius`` cells and the fused halo depth is
        ``radius * sweeps * sweep_apps``."""
        return 2 if self.ordering == "redblack" else 1

    def canon_weights(self, w, domain_shape=None):
        """Canonicalize a user weight array (a torch tensor or a numpy
        array; the result has the same type).

        ``coef="const"``: flatten to the ``(n_weights,)`` form.
        ``coef="var"``: the weights are per-point coefficient fields evaluated
        at the *output* point -- accept ``(n_weights, ...)`` (or the
        ``w_shape``-shaped leading block) with trailing dims broadcastable
        over the domain, and return ``(n_weights, *domain_shape)``.
        ``domain_shape`` is the trailing spatial shape the operator runs on
        (``(M, N, P)`` volumetric, ``(P,)`` for k-only specs) and is required
        for variable coefficients.
        """
        if not isinstance(w, (torch.Tensor, np.ndarray)):
            w = np.asarray(w)
        shape = tuple(int(s) for s in w.shape)
        if self.coef == "var":
            if domain_shape is None:
                raise ValueError(
                    f"{self.name}: variable-coefficient weights need the "
                    f"domain shape to canonicalize against")
            domain_shape = tuple(int(s) for s in domain_shape)
            lead = len(self.w_shape)
            if shape[:lead] == tuple(self.w_shape):
                w = w.reshape((self.n_weights,) + shape[lead:])
                shape = tuple(int(s) for s in w.shape)
            if len(shape) == 0 or shape[0] != self.n_weights:
                raise ValueError(
                    f"{self.name}: variable-coefficient weights must carry a "
                    f"leading ({self.n_weights},) (or {self.w_shape}) "
                    f"coefficient axis, got shape {shape}")
            tail = shape[1:]
            try:
                full = np.broadcast_shapes(tail, domain_shape)
            except ValueError:
                full = None
            if full != domain_shape:
                raise ValueError(
                    f"{self.name}: variable-coefficient weights with trailing "
                    f"shape {tail} do not broadcast over the domain "
                    f"{domain_shape}")
            w = w.reshape((self.n_weights,) + (1,) * (len(domain_shape)
                                                      - len(tail)) + tail)
            target = (self.n_weights,) + domain_shape
            if isinstance(w, torch.Tensor):
                return w.expand(target)
            return np.broadcast_to(w, target)
        if int(np.prod(shape)) != int(np.prod(self.w_shape)):
            raise ValueError(
                f"{self.name}: weights shape {shape} incompatible with "
                f"expected {self.w_shape}")
        return w.reshape(-1)

    def __post_init__(self):
        if self.ndim not in (1, 3):
            raise ValueError(f"ndim must be 1 or 3, got {self.ndim}")
        if len(self.offsets) != len(self.w_index):
            raise ValueError("offsets and w_index must be parallel")
        if (len(self.radius) != 3
                or any(r < 0 for r in self.radius)):
            raise ValueError(f"radius must be 3 non-negative ints, got "
                             f"{self.radius}")
        if self.ndim == 1 and any(di or dj for di, dj, _ in self.offsets):
            raise ValueError("ndim=1 specs may only carry k-direction taps")
        for o in self.offsets:
            if any(abs(d) > r for d, r in zip(o, self.radius)):
                raise ValueError(
                    f"offset {o} out of range for radius {self.radius}")
        if sorted(self.offsets) != list(self.offsets):
            raise ValueError("offsets must be in lexicographic order")
        if self.w_index and max(self.w_index) >= self.n_weights:
            raise ValueError("w_index refers past n_weights")
        if self.coef not in COEF_KINDS:
            raise ValueError(f"unknown coef kind {self.coef!r}; expected one "
                             f"of {COEF_KINDS}")
        if self.ordering not in ORDERING_KINDS:
            raise ValueError(f"unknown ordering {self.ordering!r}; expected "
                             f"one of {ORDERING_KINDS}")
        if self.guard not in GUARD_KINDS:
            raise ValueError(f"unknown guard {self.guard!r}; expected one "
                             f"of {GUARD_KINDS} (or pass a GuardPolicy to "
                             f"the guard= call argument)")
        # canonicalize any as_boundary spelling in place (idempotent on the
        # canonical nested-tuple form)
        object.__setattr__(self, "bc", as_boundary(self.bc))
        _validate_boundary(self.bc, self.ndim, self.radius)

    def with_bc(self, bc, name: str = None) -> "StencilSpec":
        """The same stencil under different boundary conditions.

        ``bc`` takes any :func:`as_boundary` spelling; ``name`` defaults to
        the current name (specs hash on their full value including ``bc``,
        so same-named BC variants still compile and memoize separately).
        """
        return dataclasses.replace(self, bc=as_boundary(bc),
                                   name=self.name if name is None else name)

    def with_coef(self, coef: str, name: str = None) -> "StencilSpec":
        """The same tap set with a different coefficient kind.

        ``coef="var"`` makes the weights per-point arrays evaluated at the
        output point (``out[x] = sum_t w_t(x) * u[x + off_t]``); specs hash
        on their full value including ``coef``, so the plan memo and
        ``describe()`` distinguish variable-coefficient variants
        from the constant-coefficient original for free.
        """
        return dataclasses.replace(self, coef=coef,
                                   name=self.name if name is None else name)

    def with_ordering(self, ordering: str, name: str = None) -> "StencilSpec":
        """The same stencil under a different sweep ordering.

        ``ordering="redblack"`` makes every sweep a red-black Gauss-Seidel
        sweep: the operator is applied at the *red* checkerboard parity
        (``(i + j + k) % 2 == 0`` in global coordinates), merged, then at
        the black parity reading the red-updated field.  Specs hash on their
        full value including ``ordering``, so plan memoization and
        ``describe()`` distinguish ordering variants for free;
        the plan itself (the per-application op schedule) is unchanged --
        ordering is realized by the sweep loop's checkerboard masks.
        """
        return dataclasses.replace(self, ordering=ordering,
                                   name=self.name if name is None else name)

    def with_guard(self, guard: str, name: str = None) -> "StencilSpec":
        """The same stencil under a guarded-execution level.

        ``guard`` is one of :data:`GUARD_KINDS` -- ``"off"`` (the default:
        no checks, the historical byte-identical programs), ``"nan"``
        (NaN/Inf output screening), ``"invariant"`` (+ the weight-sum
        conservation check), ``"oracle"`` (+ the sampled-plane oracle spot
        check), or ``"full"`` (every check over the full output).  The
        port carries the field so its specs equal the reference's; guarded
        execution itself is not ported yet (ROADMAP A8), so
        ``stencil_apply`` raises ``NotImplementedError`` for any level but
        ``"off"``.
        """
        return dataclasses.replace(self, guard=guard,
                                   name=self.name if name is None else name)


_REGISTRY: Dict[str, StencilSpec] = {}


def register_stencil(spec: StencilSpec, aliases: Iterable[str] = ()) -> StencilSpec:
    for key in (spec.name, *aliases):
        _REGISTRY[str(key)] = spec
    return spec


def get_stencil(stencil: Union[str, int, StencilSpec]) -> StencilSpec:
    if isinstance(stencil, StencilSpec):
        return stencil
    key = str(stencil)
    if key not in _REGISTRY:
        raise KeyError(f"unknown stencil {stencil!r}; registered: "
                       f"{sorted(set(_REGISTRY))}")
    return _REGISTRY[key]


def list_stencils() -> Dict[str, StencilSpec]:
    return dict(_REGISTRY)


def spec_from_mask(name: str, mask, ndim: int = 3, bc=None) -> StencilSpec:
    """Build a spec from an odd-shaped coefficient-index mask.

    ``mask`` has shape ``(2*ri + 1, 2*rj + 1, 2*rk + 1)`` (every extent odd;
    ``(3, 3, 3)`` is the radius-1 case) and ``mask[di + ri, dj + rj, dk +
    rk]`` is the weight index of the tap at offset ``(di, dj, dk)``; negative
    entries mean "no tap".  A boolean mask assigns every active tap its own
    weight in lexicographic order.  Integer masks must use the contiguous
    weight indices ``0..k-1`` -- a gap (e.g. ``{0, 2}``) would silently
    create a dangling unused weight, so it is rejected.
    """
    m = np.asarray(mask)
    if m.ndim != 3 or any(s < 1 or s % 2 == 0 for s in m.shape):
        raise ValueError(f"mask must be 3-D with odd extents "
                         f"(2r+1 per axis), got {m.shape}")
    ri, rj, rk = (s // 2 for s in m.shape)
    offsets, w_index = [], []
    next_w = 0
    for di in range(-ri, ri + 1):
        for dj in range(-rj, rj + 1):
            for dk in range(-rk, rk + 1):
                v = m[di + ri, dj + rj, dk + rk]
                if m.dtype == bool:
                    if not v:
                        continue
                    idx = next_w
                    next_w += 1
                else:
                    if v < 0:
                        continue
                    idx = int(v)
                offsets.append((di, dj, dk))
                w_index.append(idx)
    if m.dtype == bool:
        n_w = next_w
    else:
        used = sorted(set(w_index))
        if used and used != list(range(len(used))):
            missing = sorted(set(range(used[-1] + 1)) - set(used))
            raise ValueError(
                f"{name}: weight indices {used} skip {missing}; indices "
                f"must be contiguous 0..k-1 (a gap would leave an unused "
                f"dangling weight)")
        n_w = used[-1] + 1 if used else 0
    return StencilSpec(name=name, ndim=ndim, offsets=tuple(offsets),
                       w_index=tuple(w_index), n_weights=n_w, w_shape=(n_w,),
                       radius=(ri, rj, rk), bc=as_boundary(bc))



def _bc_from_label(label: str) -> BC:
    if label.startswith("dirichlet(") and label.endswith(")"):
        return dirichlet(float(label[len("dirichlet("):-1]))
    return BC(label)


def carry_over(fields: dict, w, device="cuda"
               ) -> Tuple[StencilSpec, torch.Tensor]:
    """Rebuild a spec from another package's plain fields, with its weights
    as a tensor on ``device``.

    ``fields`` holds ``name``, ``ndim``, ``offsets``, ``w_index``,
    ``n_weights``, ``w_shape``, ``radius``, ``bc`` (the per-axis
    :func:`bc_labels`, ``"lo|hi"`` where the sides differ), ``coef`` and
    ``ordering`` -- lists or tuples of plain ints and strings, as the
    reference package's ``StencilSpec`` carries them.  This is how an
    ad-hoc ``spec_from_mask`` spec and its weights cross from the reference
    into the port, so both compute the same operator.
    """
    bc = tuple(tuple(_bc_from_label(x) for x in lab.split("|"))
               if "|" in lab else _bc_from_label(lab)
               for lab in fields["bc"])
    spec = StencilSpec(
        name=str(fields["name"]), ndim=int(fields["ndim"]),
        offsets=tuple(tuple(int(d) for d in o) for o in fields["offsets"]),
        w_index=tuple(int(i) for i in fields["w_index"]),
        n_weights=int(fields["n_weights"]),
        w_shape=tuple(int(s) for s in fields["w_shape"]),
        radius=tuple(int(r) for r in fields["radius"]),
        bc=bc, coef=str(fields["coef"]),
        ordering=str(fields["ordering"]))
    return spec, torch.as_tensor(np.asarray(w), device=device)

def _builtin_specs() -> None:
    # 3-point: w = (w_edge, w_center), k-only (paper's 1-D streaming kernel).
    register_stencil(StencilSpec(
        name="stencil3", ndim=1,
        offsets=((0, 0, -1), (0, 0, 0), (0, 0, 1)),
        w_index=(0, 1, 0), n_weights=2, w_shape=(2,)),
        aliases=("3",))
    # 7-point: w = (wc, wk, wj, wi), 4 unique coefficients (paper sect. 3.1).
    register_stencil(StencilSpec(
        name="stencil7", ndim=3,
        offsets=((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0),
                 (0, 0, 1), (0, 1, 0), (1, 0, 0)),
        w_index=(3, 2, 1, 0, 1, 2, 3), n_weights=4, w_shape=(4,)),
        aliases=("7",))
    # 27-point: w[|di|, |dj|, |dk|], 8 unique coefficients; the tap order is
    # the legacy reference's nested (di, dj, dk) loop, so the f64 path is
    # bit-identical to the seed oracle.
    offs, widx = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                offs.append((di, dj, dk))
                widx.append(4 * abs(di) + 2 * abs(dj) + abs(dk))
    register_stencil(StencilSpec(
        name="stencil27", ndim=3, offsets=tuple(offs), w_index=tuple(widx),
        n_weights=8, w_shape=(2, 2, 2)),
        aliases=("27",))
    # star13: radius-2 axis star (the 4th-order Laplacian shape) -- one tap
    # at distance 1 and 2 along each axis plus the centre, weights shared per
    # distance: w = (w_center, w_dist1, w_dist2).
    offs, widx = [], []
    for di in range(-2, 3):
        for dj in range(-2, 3):
            for dk in range(-2, 3):
                nz = [abs(d) for d in (di, dj, dk) if d]
                if len(nz) > 1 or (nz and nz[0] > 2):
                    continue
                offs.append((di, dj, dk))
                widx.append(nz[0] if nz else 0)
    register_stencil(StencilSpec(
        name="star13", ndim=3, offsets=tuple(offs), w_index=tuple(widx),
        n_weights=3, w_shape=(3,), radius=(2, 2, 2)),
        aliases=("13",))
    # box125: the full 5x5x5 box, w[|di|, |dj|, |dk|] with shape (3, 3, 3)
    # (27 unique coefficients) -- the radius-2 analogue of stencil27.
    offs, widx = [], []
    for di in range(-2, 3):
        for dj in range(-2, 3):
            for dk in range(-2, 3):
                offs.append((di, dj, dk))
                widx.append(9 * abs(di) + 3 * abs(dj) + abs(dk))
    register_stencil(StencilSpec(
        name="box125", ndim=3, offsets=tuple(offs), w_index=tuple(widx),
        n_weights=27, w_shape=(3, 3, 3), radius=(2, 2, 2)),
        aliases=("125",))


def _builtin_bc_variants() -> None:
    """BC-suffixed registry aliases: every builtin under each non-default
    boundary condition (``dirichlet`` at the homogeneous value 0; pass an
    explicit ``spec.with_bc(dirichlet(v))`` for inhomogeneous ghosts).  For
    the k-only ``stencil3`` the BC applies to the k axis alone (i/j sides of
    a 1-D spec must stay clamp)."""
    for base in ("stencil3", "stencil7", "stencil27", "star13", "box125"):
        spec = _REGISTRY[base]
        for tag, b in (("periodic", PERIODIC), ("neumann", NEUMANN),
                       ("dirichlet", dirichlet(0.0))):
            bc = (((CLAMP, CLAMP), (CLAMP, CLAMP), (b, b))
                  if spec.ndim == 1 else b)
            register_stencil(spec.with_bc(bc, name=f"{base}_{tag}"))


def _builtin_ordering_variants() -> None:
    """Red-black Gauss-Seidel registry aliases for the volumetric builtins
    (and the k-only ``stencil3``): one checkerboarded sweep ordering per
    base spec, same taps / weights / BCs."""
    for base in ("stencil3", "stencil7", "stencil27", "star13", "box125"):
        spec = _REGISTRY[base]
        register_stencil(spec.with_ordering("redblack",
                                            name=f"{base}_redblack"))


_builtin_specs()
_builtin_bc_variants()
_builtin_ordering_variants()
