"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch`` and drives the stencil engine's main path on the card,
in four phases; any failure exits non-zero and no result line is printed.

1. Device and build: needs ``torch.cuda.is_available()``; prints
   ``nvidia-smi``'s name and power limit and each kernel's ``-Xptxas -v``
   registers / shared memory / spills.
2. Each kernel against its plain PyTorch version, on the card, on shapes no
   tile divides: ``stencil_stream`` over stencil7 / stencil27 / star13 /
   box125, sweeps 1-3, batched, and stencil27 / star13 under every
   boundary condition with constant and variable coefficients;
   ``stencil_replicate`` (sweeps fused in one launch) over the same specs,
   boundary conditions and coefficients, sweeps 1-3; ``stencil_rows`` over
   stencil3 under every k boundary condition.  Integer-valued f64 and f32
   data must match exactly; random f32 and bf16 data within the stated
   tolerance.
3. The main path at full size: ``stencil_apply`` on a (1, 512, 512, 512)
   field -- stencil27 in f32 and f64, stencil7 in f32 (2 sweeps),
   stencil27_periodic in f32, star13_neumann in f64, stencil27 with
   variable coefficients and ``bc=dirichlet(1.0)`` in f32,
   stencil27_periodic in f32 with ``sweeps=4, path="replicate"`` (on
   integer-valued data, held exactly), and stencil3 / stencil3_periodic on
   the field's 262,144 rows of 512 (2 sweeps) -- each held against the
   plain version, with the kernels' launch counters set to 0 just before
   and read just after.
4. Times, with CUDA events after a warm-up: each kernel at its main-path
   shape beside its bound, its plain version and one PyTorch library call
   computing the same function where there is one (``conv3d`` / ``conv1d``
   plus the ring mask, or after ``F.pad(mode="circular")``, TF32 off):
   stencil27 in f32 and f64; the streaming kernel under a periodic and a
   neumann boundary and with variable coefficients; the replicated-halo
   kernel fusing 1, 2 and 4 sweeps beside as many chained streaming
   launches; the row kernel under a periodic boundary and with variable
   coefficients; then ``stencil_apply`` with 8 and 64 sweeps, per sweep.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 512                     # full field: (1, N, N, N)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
PEAK_FLOPS = {torch.float32: 67e12,   # H100 SXM, outside the tensor cores
              torch.float64: 34e12}   # (NVIDIA H100 data sheet)
TIMED_REPS = 20
EPS32 = torch.finfo(torch.float32).eps


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps=TIMED_REPS, warmup=3):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(x, y):
    return float((x.double() - y.double()).abs().max())


def sum_tol(a, w, taps, sweeps, eps, v=0.0):
    """Bound on the difference of two summation orders: each of the
    ``2 * taps * sweeps`` roundings is within ``eps`` of the largest
    magnitude any value reaches, ``(taps * max|w|)**sweeps * max(max|a|,
    |v|)`` -- ``v`` the dirichlet ghost value, which a ghost holds."""
    scale = (taps * float(w.abs().max())) ** sweeps * max(
        float(a.abs().max()), abs(v))
    return 2 * taps * sweeps * eps * scale


def replicate_flops(shape, tile, radius, sweeps, group, taps):
    """Flops the replicated-halo kernel does, its halo's redundant sweeps
    included: each launch fuses ``group`` sweeps, and sweep ``q`` of a
    launch of ``g`` computes every tile widened by ``r * (g - q)``.  A
    diagnostic beside the bound, which counts the function's own
    ``2 * taps * sweeps`` flops per point."""
    b, m, n, p = shape
    tiles = b * -(-m // tile[0]) * -(-n // tile[1]) * -(-p // tile[2])
    flops = 0
    left = sweeps
    while left:
        g = min(group, left)
        for q in range(1, g + 1):
            pts = 1
            for t, r in zip(tile, radius):
                pts *= t + 2 * r * (g - q)
            flops += 2 * taps * tiles * pts
        left -= g
    return flops


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.stencil_engine import (
        autotune_engine, build_kernels, bytes_per_point, compile_plan,
        dirichlet, get_stencil, pick_block_rows, replicate_tile,
        stencil_apply, stencil_replicate, stencil_replicate_plain,
        stencil_rows, stencil_rows_plain, stencil_stream,
        stencil_stream_plain)
    from repro_torch.kernels.stencil_engine.kernel import (acc_dtype_for,
                                                           ghost_value)

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.time()

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    logs = build_kernels()
    print(f"[build] {time.time() - t0:.1f} s")
    for src, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[build] {src} {kernel}: "
                      f"{line.replace('ptxas info    :', '').strip()}")

    # -- 2. each kernel against its plain version --------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    cgen = torch.Generator(device=dev).manual_seed(0)

    def ints(shape, hi, dtype):
        return torch.randint(-hi, hi + 1, shape, generator=gen).to(
            device=dev, dtype=dtype)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)

    def spec_of(name, bc=None, coef="const"):
        spec = get_stencil(name)
        spec = spec if bc is None else spec.with_bc(bc)
        return spec.with_coef("var") if coef == "var" else spec

    def weights(spec, shape, draw, dtype):
        """Flat weights, or coefficient fields over ``shape``'s domain."""
        lead = (spec.n_weights,)
        if spec.coef == "var":
            lead += tuple(shape[-spec.ndim:])
        return draw(lead, acc_dtype_for(dtype))

    def against_plain(label, kernel, plain, spec, shape, sweeps, dtypes):
        """Integer-valued data (|values| <= 2 * 125**3 < 2**24 with weights
        in [-1, 1]) must match exactly; random f32 within the summation
        bound; bf16 in, f32 accumulation, one cast: within one bf16 ulp
        (2**-7 relative) of the plain version's f32 result, plus that
        bound.  Returns the number of cases."""
        v = ghost_value(spec)
        for dtype in dtypes:
            a = ints(shape, 2, dtype)
            w = weights(spec, shape, lambda s, d: ints(s, 1, d), dtype)
            got, want = kernel(a, w), plain(a, w)
            check(torch.equal(got, want),
                  f"{label} {dtype}: kernel != plain on integers (max err "
                  f"{max_abs(got, want)})")
        a = randn(shape, torch.float32)
        w = weights(spec, shape, randn, torch.float32)
        got = kernel(a, w)
        want = plain(a.double(), w.double())
        tol = sum_tol(a, w, spec.taps, sweeps, EPS32, v)
        err = max_abs(got, want)
        check(err <= tol, f"{label} f32: err {err} > tol {tol}")
        a = randn(shape, torch.bfloat16)
        got = kernel(a, w)
        ref32 = plain(a.float(), w)
        ulp = torch.exp2(torch.floor(torch.log2(
            ref32.abs().clamp_min(1e-30))) - 7)
        tol = sum_tol(a, w, spec.taps, sweeps, EPS32, v)
        check(bool(((got.float() - ref32).abs() <= ulp + tol).all()),
              f"{label} bf16: beyond one ulp")
        return len(dtypes) + 2

    volumetric = ("stencil7", "stencil27", "star13", "box125")
    bcs = {"periodic": "periodic", "neumann": "neumann",
           "dirichlet(2)": dirichlet(2.0),
           "mix": ("periodic", "neumann", dirichlet(2.0))}
    exact = (torch.float64, torch.float32)
    # (shape, (block_i, block_j)): tiles that do not divide the shape, a
    # batch, and 1, 2 and 8 rows per thread (box125's 8-row window is past
    # the 48 KB that needs the opt-in)
    cases = [((2, 40, 72, 100), (20, 16)), ((1, 16, 12, 24), (8, 8)),
             ((2, 40, 72, 100), (6, 64))]
    n_cases = 0
    for name in volumetric:
        plan = compile_plan(name)
        for shape, (bi, bj) in cases:
            for sweeps in (1, 2, 3):
                n_cases += against_plain(
                    f"stream {name} {shape} s={sweeps}",
                    lambda a, w: stencil_stream(a, w, plan, bi, bj, sweeps),
                    lambda a, w: stencil_stream_plain(a, w, plan, sweeps),
                    plan.spec, shape, sweeps, exact)
    for name in ("stencil27", "star13"):
        for key, bc in bcs.items():
            for coef in ("const", "var"):
                plan = compile_plan(spec_of(name, bc, coef))
                for shape, (bi, bj) in (((2, 40, 72, 100), (6, 16)),
                                        ((1, 4, 12, 24), (4, 64))):
                    n_cases += against_plain(
                        f"stream {name} {key} {coef} {shape}",
                        lambda a, w: stencil_stream(a, w, plan, bi, bj, 2),
                        lambda a, w: stencil_stream_plain(a, w, plan, 2),
                        plan.spec, shape, 2, exact)
    print(f"[kernel-vs-plain] stencil_stream: {n_cases} cases agree "
          f"(clamp, every BC, var coef; integer f64/f32 exact; f32 within "
          f"2*taps*s*eps32*scale; bf16 within 1 ulp + that)")
    n_cases = 0
    launches0 = stencil_replicate.launches
    for name in volumetric:
        for key, bc in (("clamp", None),) + tuple(bcs.items()):
            for coef in ("const", "var") if name in ("stencil27",
                                                     "star13") else ("const",):
                plan = compile_plan(spec_of(name, bc, coef))
                for shape, blocks in (((2, 40, 72, 100), (None, None)),
                                      ((1, 4, 12, 24), (1, 8))):
                    for sweeps in (1, 2, 3):
                        if blocks[0] is None:
                            _, bi, bj = autotune_engine(
                                *shape[1:], 4, sweeps=sweeps, plan=plan,
                                batch=shape[0], path="replicate")
                        else:
                            bi, bj = blocks
                        n_cases += against_plain(
                            f"replicate {name} {key} {coef} {shape} "
                            f"s={sweeps}",
                            lambda a, w: stencil_replicate(a, w, plan, bi,
                                                           bj, sweeps),
                            lambda a, w: stencil_replicate_plain(a, w, plan,
                                                                 sweeps),
                            plan.spec, shape, sweeps, exact)
    print(f"[kernel-vs-plain] stencil_replicate: {n_cases} cases agree in "
          f"{stencil_replicate.launches - launches0} launches (clamp, every "
          f"BC, var coef, sweeps 1-3 fused)")
    plan3 = compile_plan("stencil3")
    for shape in ((4096, 512), (N * N, N)):
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            a = ints(shape, 2, dtype)
            br = pick_block_rows(shape[0], shape[1], a.element_size())
            w = torch.tensor([1.0, -2.0], device=dev,
                             dtype=acc_dtype_for(dtype))
            for sweeps in (1, 3):
                got = stencil_rows(a, w, plan3, br, sweeps)
                want = stencil_rows_plain(a, w, plan3, sweeps)
                check(torch.equal(got, want),
                      f"stencil3 {shape} {dtype} s={sweeps}: kernel != plain"
                      f" (max err {max_abs(got, want)})")
    n_cases = 0
    for key, bc in bcs.items():
        kbc = bc[2] if isinstance(bc, tuple) else bc
        for coef in ("const", "var"):
            spec = spec_of("stencil3", ("clamp", "clamp", kbc), coef)
            plan = compile_plan(spec)
            for shape in ((4096, 512), (3000, 300)):
                br = pick_block_rows(shape[0], shape[1], 4)
                n_cases += against_plain(
                    f"rows stencil3 {key} {coef} {shape}",
                    lambda a, w: stencil_rows(a, w, plan, br, 3),
                    lambda a, w: stencil_rows_plain(a, w, plan, 3),
                    spec, shape, 3, exact)
    print("[kernel-vs-plain] stencil_rows: stencil3 (4096, 512) and "
          f"({N * N}, {N}), f64/f32/bf16, s=1,3 exact; {n_cases} cases "
          f"under every k BC and var coef agree")
    print(f"[phase 2] {time.time() - t_start:.1f} s since start")

    # -- 3. main path at full size -----------------------------------------
    field32 = torch.randn((1, N, N, N), generator=cgen, device=dev)
    field64 = torch.randn((1, N, N, N), generator=cgen, device=dev,
                          dtype=torch.float64)
    coef27 = torch.randn((8, N, N, N), generator=cgen, device=dev)
    # integer-valued f32 for the fused 4-sweep run, held exactly: |values|
    # <= 2 * 27**4 < 2**24 with weights in [-1, 1]
    ints32 = torch.randint(-2, 3, (1, N, N, N), generator=cgen, device=dev,
                           dtype=torch.float32)
    var27 = spec_of("stencil27", coef="var")
    # (label, stencil, field, weights, sweeps, keywords)
    runs = [("stencil27", "stencil27", field32,
             torch.randn(2, 2, 2, generator=gen), 1, {}),
            ("stencil27", "stencil27", field64,
             torch.randn(2, 2, 2, generator=gen), 1, {}),
            ("stencil7", "stencil7", field32, torch.randn(4, generator=gen),
             2, {}),
            ("stencil3", "stencil3", field32, torch.randn(2, generator=gen),
             2, {}),
            ("stencil27_periodic", "stencil27_periodic", field32,
             torch.randn(2, 2, 2, generator=gen), 1, {}),
            ("star13_neumann", "star13_neumann", field64,
             torch.randn(3, generator=gen), 1, {}),
            ("stencil27 var dirichlet(1)", var27, field32, coef27, 1,
             {"bc": dirichlet(1.0)}),
            ("stencil27_periodic replicate", "stencil27_periodic", ints32,
             torch.randint(-1, 2, (2, 2, 2), generator=gen).float(), 4,
             {"path": "replicate"}),
            ("stencil3_periodic", "stencil3_periodic", field32,
             torch.randn(2, generator=gen), 2, {})]
    stencil_stream.launches = 0
    stencil_replicate.launches = 0
    stencil_rows.launches = 0
    t0 = time.time()
    outs = [stencil_apply(a, w, st, sweeps=s, **kw)
            for _, st, a, w, s, kw in runs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"stencil_stream": stencil_stream.launches,
                "stencil_replicate": stencil_replicate.launches,
                "stencil_rows": stencil_rows.launches}
    print(f"[main-path] {len(runs)} stencil_apply calls at {N}^3 in "
          f"{wall:.3f} s (host clock, first calls); launches {launches}")
    want_launches = {"stencil_stream": 7, "stencil_replicate": 1,
                     "stencil_rows": 2}
    check(launches == want_launches, f"main path launch counts {launches}, "
          f"expected {want_launches}")
    main_err = {}
    for (label, st, a, w, s, kw), out in zip(runs, outs):
        check(out.shape == a.shape and out.dtype == a.dtype
              and out.device == a.device, f"{label}: wrong result metadata")
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        spec = get_stencil(st)
        if "bc" in kw:
            spec = spec.with_bc(kw["bc"])
        plan = compile_plan(spec)
        acc = acc_dtype_for(a.dtype)
        wf = spec.canon_weights(w, a.shape[-spec.ndim:]).to(dev, acc)
        if spec.ndim == 1:
            kernel = "stencil_rows"
            want = stencil_rows_plain(a.reshape(-1, N), wf, plan, s)
        elif kw.get("path") == "replicate":
            kernel = "stencil_replicate"
            want = stencil_replicate_plain(a, wf, plan, s)
        else:
            kernel = "stencil_stream"
            want = stencil_stream_plain(a, wf, plan, s)
        if a is ints32:
            tol = 0.0
            check(torch.equal(out, want), f"{label}: main path != plain on "
                  f"integers (max err {max_abs(out, want)})")
        else:
            tol = sum_tol(a, wf, spec.taps, s, torch.finfo(acc).eps,
                          ghost_value(spec))
        err = max_abs(out.reshape(want.shape), want)
        check(err <= tol, f"{label} {a.dtype}: main path err {err} > {tol}")
        main_err.setdefault(kernel, err)
        print(f"[main-path] {label} {str(a.dtype)[6:]}"
              f"{' integer-valued' if a is ints32 else ''} sweeps={s}: max "
              f"|err| vs plain {err:.3e} (tol {tol:.3e}), finite, shape ok")
        del want
    del outs, ints32
    print(f"[phase 3] {time.time() - t_start:.1f} s since start")

    # -- 4. times ----------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    F = torch.nn.functional
    kernels = []
    times = []

    def ring_mask(shape):
        idx = [torch.arange(s, device=dev) for s in shape]
        m = None
        for ax, ix in enumerate(idx):
            v = ((ix > 0) & (ix < shape[ax] - 1)).view(
                [-1 if d == ax else 1 for d in range(len(shape))])
            m = v if m is None else m & v
        return m

    def conv_weight(spec, w, dtype):
        """The spec's taps as a conv3d weight (a cross-correlation:
        weight[d + r] scales u[x + d])."""
        r = spec.radius
        wt = torch.zeros([2 * x + 1 for x in r], device=dev, dtype=dtype)
        for (di, dj, dk), wi in zip(spec.offsets, spec.w_index):
            wt[di + r[0], dj + r[1], dk + r[2]] = w[wi]
        return wt.view((1, 1) + tuple(wt.shape))

    def bounds(nbytes, flops, dtype):
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = flops / PEAK_FLOPS[dtype] * 1e3
        return max(b, o), ("bytes" if b >= o else "operations"), b, o

    def kernel_row(name, source, replaces, ms, plain_ms, bound, library_ms):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/stencil_engine/csrc/" + source,
            "replaces": "src/repro/kernels/stencil_engine/" + replaces,
            "launches": launches[name], "max_abs_err": main_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms})

    for dtype in (torch.float32, torch.float64):
        plan = compile_plan("stencil27")
        a = field32 if dtype == torch.float32 else field64
        w = torch.randn(8, generator=gen).to(dev, dtype)
        _, bi, bj = autotune_engine(N, N, N, a.element_size(), plan=plan)
        ms = cuda_time_ms(lambda: stencil_stream(a, w, plan, bi, bj, 1))
        plain_ms = cuda_time_ms(
            lambda: stencil_stream_plain(a, w, plan, 1), reps=3, warmup=1)
        pts = a.numel()
        bound = bounds(2 * a.element_size() * pts,
                       2 * plan.spec.taps * pts, dtype)
        wt = conv_weight(plan.spec, w, dtype)
        mask = ring_mask((N, N, N))

        def library():
            return F.conv3d(a, wt, padding=1) * mask
        lib_out = library()
        err = max_abs(lib_out, stencil_stream(a, w, plan, bi, bj, 1))
        # 1e-3 in f32, scaled by the unit roundoff for f64
        lib_tol = 1e-3 * torch.finfo(dtype).eps / EPS32
        check(err < lib_tol, f"conv3d yardstick disagrees in {dtype}: "
              f"{err} >= {lib_tol}")
        library_ms = cuda_time_ms(library, reps=5, warmup=1)
        del lib_out
        times.append({"name": "stencil_stream", "dtype": str(dtype)[6:],
                      "shape": [1, N, N, N], "spec": "stencil27",
                      "sweeps": 1, "block_i": bi, "block_j": bj, "ms": ms,
                      "plain_ms": plain_ms, "bytes_bound_ms": bound[2],
                      "ops_bound_ms": bound[3], "library_ms": library_ms})
        if dtype == torch.float32:
            kernel_row("stencil_stream", "stencil_stream.cu",
                       "kernel.py:496", ms, plain_ms, bound, library_ms)

    for rows in (N * N, 4096):
        a = field32.reshape(-1, N)[:rows]
        w = torch.randn(2, generator=gen).to(dev)
        sweeps = 2
        br = pick_block_rows(rows, N, 4)
        ms = cuda_time_ms(lambda: stencil_rows(a, w, plan3, br, sweeps))
        plain_ms = cuda_time_ms(
            lambda: stencil_rows_plain(a, w, plan3, sweeps), reps=3, warmup=1)
        wt = torch.stack([w[0], w[1], w[0]]).view(1, 1, 3)
        kmask = ring_mask((N,))

        def library():
            u = a.view(rows, 1, N)
            for _ in range(sweeps):
                u = F.conv1d(u, wt, padding=1) * kmask
            return u.view(rows, N)
        err = max_abs(library(), stencil_rows(a, w, plan3, br, sweeps))
        check(err < 1e-4, f"conv1d yardstick disagrees: {err}")
        library_ms = cuda_time_ms(library, reps=5, warmup=1)
        pts = a.numel()
        bound = bounds(2 * 4 * pts, 2 * 3 * sweeps * pts, torch.float32)
        times.append({"name": "stencil_rows", "dtype": "float32",
                      "shape": [rows, N], "spec": "stencil3",
                      "sweeps": sweeps, "block_rows": br, "ms": ms,
                      "plain_ms": plain_ms, "bytes_bound_ms": bound[2],
                      "ops_bound_ms": bound[3], "library_ms": library_ms})
        if rows == N * N:
            kernel_row("stencil_rows", "stencil_rows.cu", "kernel.py:766",
                       ms, plain_ms, bound, library_ms)

    # the streaming kernel under boundary conditions and with variable
    # coefficients, at 512^3
    sub = [("stencil27_periodic", field32, None), ("star13_neumann", field64,
                                                  None),
           ("stencil27 var dirichlet(1)", field32, coef27)]
    for label, a, coef in sub:
        if coef is None:
            plan = compile_plan(label)
            w = torch.randn(plan.spec.n_weights, generator=gen).to(
                dev, a.dtype)
        else:
            plan = compile_plan(var27.with_bc(dirichlet(1.0)))
            w = coef
        _, bi, bj = autotune_engine(N, N, N, a.element_size(), plan=plan)
        ms = cuda_time_ms(lambda: stencil_stream(a, w, plan, bi, bj, 1))
        plain_ms = cuda_time_ms(
            lambda: stencil_stream_plain(a, w, plan, 1), reps=3, warmup=1)
        pts = a.numel()
        nbytes = pts * bytes_per_point("stream", a.element_size(), 1,
                                       plan.spec.coef, plan.spec.n_weights)
        bound = bounds(nbytes, 2 * plan.spec.taps * pts, a.dtype)
        library_ms = None
        if plan.spec.bc[0][0].kind == "periodic" and coef is None:
            wt = conv_weight(plan.spec, w, a.dtype)

            def library():
                return F.conv3d(F.pad(a, (1,) * 6, mode="circular"), wt)
            err = max_abs(library(), stencil_stream(a, w, plan, bi, bj, 1))
            check(err < 1e-3, f"pad + conv3d yardstick disagrees: {err}")
            library_ms = cuda_time_ms(library, reps=5, warmup=1)
        times.append({"name": "stencil_stream", "dtype": str(a.dtype)[6:],
                      "shape": [1, N, N, N], "spec": label, "sweeps": 1,
                      "block_i": bi, "block_j": bj, "ms": ms,
                      "plain_ms": plain_ms, "bytes_bound_ms": bound[2],
                      "ops_bound_ms": bound[3], "library_ms": library_ms})

    # the replicated-halo kernel fusing s sweeps, beside s chained streaming
    # launches and s rounds of circular pad + conv3d
    plan = compile_plan("stencil27_periodic")
    w = torch.randn(8, generator=gen).to(dev)
    wt = conv_weight(plan.spec, w, torch.float32)
    _, sbi, sbj = autotune_engine(N, N, N, 4, plan=plan)
    for sweeps in (1, 2, 4):
        _, bi, bj = autotune_engine(N, N, N, 4, sweeps=sweeps, plan=plan,
                                    path="replicate")
        ti, tj, tk, group = replicate_tile(N, N, N, 4, sweeps,
                                           plan.spec.radius)
        ms = cuda_time_ms(
            lambda: stencil_replicate(field32, w, plan, bi, bj, sweeps))
        plain_ms = cuda_time_ms(
            lambda: stencil_replicate_plain(field32, w, plan, sweeps),
            reps=3, warmup=1)
        chained_ms = cuda_time_ms(
            lambda: stencil_stream(field32, w, plan, sbi, sbj, sweeps))

        def library():
            u = field32
            for _ in range(sweeps):
                u = F.conv3d(F.pad(u, (1,) * 6, mode="circular"), wt)
            return u
        err = max_abs(library(), stencil_replicate(field32, w, plan, bi, bj,
                                                   sweeps))
        check(err < 1e-3 * sweeps, f"pad + conv3d yardstick disagrees at "
              f"s={sweeps}: {err}")
        library_ms = cuda_time_ms(library, reps=5, warmup=1)
        # the function's bound: each point read once and written once,
        # 2 * taps flops per point per sweep
        pts = field32.numel()
        bound = bounds(2 * 4 * pts, 2 * plan.spec.taps * sweeps * pts,
                       torch.float32)
        halo_flops = replicate_flops(field32.shape, (ti, tj, tk),
                                     plan.spec.radius, sweeps, group,
                                     plan.spec.taps)
        times.append({"name": "stencil_replicate", "dtype": "float32",
                      "shape": [1, N, N, N], "spec": "stencil27_periodic",
                      "sweeps": sweeps, "tile": [ti, tj, tk],
                      "sweeps_per_launch": group, "ms": ms,
                      "plain_ms": plain_ms, "chained_stream_ms": chained_ms,
                      "bytes_bound_ms": bound[2], "ops_bound_ms": bound[3],
                      "ops_with_halo_ms": halo_flops
                      / PEAK_FLOPS[torch.float32] * 1e3,
                      "library_ms": library_ms})
        if sweeps == 4:
            kernel_row("stencil_replicate", "stencil_replicate.cu",
                       "kernel.py:435", ms, plain_ms, bound, library_ms)

    # the row kernel under a periodic boundary and with variable
    # coefficients, 262,144 rows of 512, 2 sweeps
    a = field32.reshape(-1, N)
    br = pick_block_rows(N * N, N, 4)
    for label, spec in (("stencil3_periodic", get_stencil(
            "stencil3_periodic")), ("stencil3 var", spec_of(
                "stencil3", coef="var"))):
        plan = compile_plan(spec)
        w = torch.randn((2, N) if spec.coef == "var" else (2,),
                        generator=gen).to(dev)
        ms = cuda_time_ms(lambda: stencil_rows(a, w, plan, br, 2))
        plain_ms = cuda_time_ms(
            lambda: stencil_rows_plain(a, w, plan, 2), reps=3, warmup=1)
        library_ms = None
        if spec.coef == "const":
            wt = torch.stack([w[0], w[1], w[0]]).view(1, 1, 3)

            def library():
                u = a.view(N * N, 1, N)
                for _ in range(2):
                    u = F.conv1d(F.pad(u, (1, 1), mode="circular"), wt)
                return u.view(N * N, N)
            err = max_abs(library(), stencil_rows(a, w, plan, br, 2))
            check(err < 1e-4, f"pad + conv1d yardstick disagrees: {err}")
            library_ms = cuda_time_ms(library, reps=5, warmup=1)
        pts = a.numel()
        # coefficients: one (2, P) row set, read once
        bound = bounds(2 * 4 * pts + w.numel() * 4, 2 * 3 * 2 * pts,
                       torch.float32)
        times.append({"name": "stencil_rows", "dtype": "float32",
                      "shape": [N * N, N], "spec": label, "sweeps": 2,
                      "block_rows": br, "ms": ms, "plain_ms": plain_ms,
                      "bytes_bound_ms": bound[2], "ops_bound_ms": bound[3],
                      "library_ms": library_ms})
    for row in times:
        print("[times] " + json.dumps(row))

    # many-sweep Jacobi runs, one launch per sweep: the blocks
    # stencil_apply picks against (64, 32), the pick of a chooser that held
    # chosen blocks to the fused kernel's halo r_i * sweeps
    w27 = torch.randn(2, 2, 2, generator=gen)
    plan27 = compile_plan("stencil27")
    w27f = w27.reshape(-1).to(dev)
    for sweeps in (8, 64):
        _, bi, bj = autotune_engine(N, N, N, 4, sweeps=sweeps, plan=plan27)
        row = {"spec": "stencil27", "dtype": "float32", "shape": [1, N, N, N],
               "sweeps": sweeps, "block_i": bi, "block_j": bj}
        for key, (qi, qj) in (("ms_per_sweep", (bi, bj)),
                              ("ms_per_sweep_at_64_32", (64, 32))):
            row[key] = cuda_time_ms(
                lambda: stencil_stream(field32, w27f, plan27, qi, qj, sweeps),
                reps=3, warmup=1) / sweeps
        # the chained launches' bytes (autotune.py:bytes_per_point)
        row["bytes_bound_ms_per_sweep"] = (
            bytes_per_point("stream", 4, sweeps) * N ** 3
            / HBM_BYTES_PER_S * 1e3)
        print("[sweeps] " + json.dumps(row))

    # end to end: back-to-back stencil_apply calls, weights on the host as
    # a user passes them; host clock without the profiler, then the
    # device's busy share from the profiler over a second window
    from torch.profiler import ProfilerActivity, profile
    calls = 20

    def apply_calls():
        t0 = time.perf_counter()
        for _ in range(calls):
            stencil_apply(field32, w27, "stencil27")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    apply_calls()
    wall_ms = apply_calls()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = apply_calls()
    busy_ms = sum(getattr(e, "self_device_time_total", 0)
                  for e in prof.key_averages()) / 1e3
    print("[end-to-end] " + json.dumps({
        "call": "stencil_apply(stencil27, f32, 512^3, sweeps=1)",
        "calls": calls, "ms_per_call": wall_ms / calls,
        "kernel_ms": times[0]["ms"],
        "device_busy_share_profiled":
            busy_ms / prof_wall_ms if busy_ms else None}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
