"""The legacy per-stencil entry points, built by two factories.

The seed-era ``stencil3`` / ``stencil7`` / ``stencil27`` wrappers and their
``*_ref`` oracles, as the reference package's ``kernels/_compat.py`` builds
them (``_make_entry`` / ``_make_ref``): each is ``stencil_apply`` /
``stencil_ref`` with the stencil's name filled in and its historical
block-size keyword (``block_rows`` for the k-only ``stencil3``, ``block_i``
otherwise).  Plain functions: PyTorch runs eagerly, so there is no jit, and
the reference's ``interpret`` flag has no counterpart.
"""

from __future__ import annotations

# One row per legacy entry point: registry name -> (name of the block-size
# keyword the seed API used, weights-layout docstring).
_SHIMS = {
    "stencil3": ("block_rows", "Symmetric 3-point stencil along the last "
                               "axis; ``w = (w_edge, w_center)``."),
    "stencil7": ("block_i", "Symmetric 7-point stencil; "
                            "``w = (wc, wk, wj, wi)``."),
    "stencil27": ("block_i", "Symmetric 27-point stencil; ``w`` has shape "
                             "(2, 2, 2)."),
}


def _make_entry(name: str, blk: str, doc: str):
    """Build the legacy entry point ``name(a, w, <blk>=None)`` over the
    engine's ``stencil_apply``."""
    def entry(a, w, **kw):
        bad = set(kw) - {blk}
        if bad:
            raise TypeError(f"{name}() got an unexpected keyword argument "
                            f"{sorted(bad)[0]!r}")
        from .stencil_engine.ops import stencil_apply
        return stencil_apply(a, w, name, block_i=kw.get(blk))
    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = f"{doc}\n\n    ``{name}(a, w, {blk}=None)``."
    return entry


def _make_ref(name: str):
    """Build the legacy oracle ``name_ref(a, w)`` over ``stencil_ref``."""
    def ref(a, w):
        from .stencil_engine.ref import stencil_ref
        return stencil_ref(a, w, name)
    ref.__name__ = ref.__qualname__ = f"{name}_ref"
    ref.__doc__ = (f"PyTorch oracle for the {name[len('stencil'):]}-point "
                   f"stencil (engine-backed).")
    return ref


stencil3 = _make_entry("stencil3", *_SHIMS["stencil3"])
stencil7 = _make_entry("stencil7", *_SHIMS["stencil7"])
stencil27 = _make_entry("stencil27", *_SHIMS["stencil27"])
stencil3_ref = _make_ref("stencil3")
stencil7_ref = _make_ref("stencil7")
stencil27_ref = _make_ref("stencil27")
