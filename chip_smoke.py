"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch`` and drives the stencil engine's main path on the card,
in four phases; any failure exits non-zero and no result line is printed.

1. Device and build: needs ``torch.cuda.is_available()``; prints
   ``nvidia-smi``'s name and power limit and each kernel's ``-Xptxas -v``
   registers / shared memory / spills.
2. Each kernel against its plain PyTorch version, on the card:
   ``stencil_stream`` over stencil7 / stencil27 / star13 / box125, sweeps
   1-3, batched, on a shape no tile divides; ``stencil_rows`` over stencil3.
   Integer-valued f64 and f32 data must match exactly; random f32 and bf16
   data within the stated tolerance.
3. The main path at full size: ``stencil_apply`` on a (1, 512, 512, 512)
   field -- stencil27 in f32 and f64, stencil7 in f32 (2 sweeps), stencil3
   on its 262,144 rows of 512 (2 sweeps) -- each held against the plain
   version, with the kernels' launch counters set to 0 just before and read
   just after.
4. Times, with CUDA events after a warm-up: each kernel at its main-path
   shape beside its bound, its plain version and one PyTorch library call
   computing the same function (``conv3d`` / ``conv1d`` plus the ring
   mask, TF32 off), for stencil27 in f32 and f64; then ``stencil_apply``
   with 8 and 64 sweeps, per sweep.

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


def sum_tol(a, w, taps, sweeps, eps):
    """Bound on the difference of two summation orders: each of the
    ``2 * taps * sweeps`` roundings is within ``eps`` of the largest
    magnitude any value reaches, ``(taps * max|w|)**sweeps * max|a|``."""
    scale = (taps * float(w.abs().max())) ** sweeps * float(a.abs().max())
    return 2 * taps * sweeps * eps * scale


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.stencil_engine import (
        autotune_engine, build_kernels, bytes_per_point, compile_plan,
        pick_block_rows,
        stencil_apply, stencil_rows, stencil_rows_plain, stencil_stream,
        stencil_stream_plain)
    from repro_torch.kernels.stencil_engine.kernel import acc_dtype_for

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

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

    def ints(shape, hi, dtype):
        return torch.randint(-hi, hi + 1, shape, generator=gen).to(
            device=dev, dtype=dtype)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)

    volumetric = {"stencil7": 4, "stencil27": 8, "star13": 3, "box125": 27}
    # (shape, (block_i, block_j)): tiles that do not divide the shape, a
    # batch, and 1, 2 and 8 rows per thread (box125's 8-row window is past
    # the 48 KB that needs the opt-in)
    cases = [((2, 40, 72, 100), (20, 16)), ((1, 16, 12, 24), (8, 8)),
             ((2, 40, 72, 100), (6, 64))]
    n_cases = 0
    for name, nw in volumetric.items():
        plan = compile_plan(name)
        for shape, (bi, bj) in cases:
            for sweeps in (1, 2, 3):
                # integer-valued: |values| <= 2 * 125**3 < 2**24, exact
                for dtype in (torch.float64, torch.float32):
                    a = ints(shape, 2, dtype)
                    w = ints((nw,), 1, dtype)
                    got = stencil_stream(a, w, plan, bi, bj, sweeps)
                    want = stencil_stream_plain(a, w, plan, sweeps)
                    check(torch.equal(got, want),
                          f"{name} {shape} s={sweeps} {dtype}: kernel != "
                          f"plain on integers (max err {max_abs(got, want)})")
                # random f32: each of the 2*taps*sweeps roundings is within
                # eps32 of the largest magnitude any value reaches
                a = randn(shape, torch.float32)
                w = randn((nw,), torch.float32)
                got = stencil_stream(a, w, plan, bi, bj, sweeps)
                want = stencil_stream_plain(a.double(), w.double(), plan,
                                            sweeps)
                tol = sum_tol(a, w, plan.spec.taps, sweeps, EPS32)
                err = max_abs(got, want)
                check(err <= tol, f"{name} {shape} s={sweeps} f32: err "
                      f"{err} > tol {tol}")
                # bf16 in, f32 accumulation, one cast: within one bf16 ulp
                # (2**-7 relative) of the plain version's f32 result, plus
                # the f32 bound above for the two summation orders
                a = randn(shape, torch.bfloat16)
                got = stencil_stream(a, w, plan, bi, bj, sweeps)
                ref32 = stencil_stream_plain(a.float(), w, plan, sweeps)
                ulp = torch.exp2(torch.floor(torch.log2(
                    ref32.abs().clamp_min(1e-30))) - 7)
                tol = sum_tol(a, w, plan.spec.taps, sweeps, EPS32)
                check(bool(((got.float() - ref32).abs() <= ulp + tol).all()),
                      f"{name} {shape} s={sweeps} bf16: beyond one ulp")
                n_cases += 4
    print(f"[kernel-vs-plain] stencil_stream: {n_cases} cases agree "
          f"(integer f64/f32 exact; f32 within 2*taps*s*eps32*scale; bf16 "
          f"within 1 ulp + that)")
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
    print("[kernel-vs-plain] stencil_rows: stencil3 (4096, 512) and "
          f"({N * N}, {N}), f64/f32/bf16, s=1,3 exact")

    # -- 3. main path at full size -----------------------------------------
    field32 = randn((1, N, N, N), torch.float32)
    field64 = randn((1, N, N, N), torch.float64)
    runs = [("stencil27", field32, torch.randn(2, 2, 2, generator=gen), 1),
            ("stencil27", field64, torch.randn(2, 2, 2, generator=gen), 1),
            ("stencil7", field32, torch.randn(4, generator=gen), 2),
            ("stencil3", field32, torch.randn(2, generator=gen), 2)]
    stencil_stream.launches = 0
    stencil_rows.launches = 0
    t0 = time.time()
    outs = [stencil_apply(a, w, name, sweeps=s) for name, a, w, s in runs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"stencil_stream": stencil_stream.launches,
                "stencil_rows": stencil_rows.launches}
    print(f"[main-path] {len(runs)} stencil_apply calls at {N}^3 in "
          f"{wall:.3f} s (host clock, first calls); launches {launches}")
    check(launches["stencil_stream"] == 4 and launches["stencil_rows"] == 1,
          f"main path launch counts {launches}, expected 4 and 1")
    main_err = {}
    for (name, a, w, s), out in zip(runs, outs):
        check(out.shape == a.shape and out.dtype == a.dtype
              and out.device == a.device, f"{name}: wrong result metadata")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        plan = compile_plan(name)
        acc = acc_dtype_for(a.dtype)
        wf = w.reshape(-1).to(dev, acc)
        if plan.spec.ndim == 1:
            want = stencil_rows_plain(a.reshape(-1, N), wf, plan, s)
        else:
            want = stencil_stream_plain(a, wf, plan, s)
        tol = sum_tol(a, wf, plan.spec.taps, s, torch.finfo(acc).eps)
        err = max_abs(out.reshape(want.shape), want)
        check(err <= tol, f"{name} {a.dtype}: main path err {err} > {tol}")
        main_err.setdefault("stencil_rows" if plan.spec.ndim == 1
                            else "stencil_stream", err)
        print(f"[main-path] {name} {str(a.dtype)[6:]} sweeps={s}: max |err| "
              f"vs plain {err:.3e} (tol {tol:.3e}), finite, shape ok")
        del want

    # -- 4. times ----------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    for dtype in (torch.float32, torch.float64):
        plan = compile_plan("stencil27")
        a = field32 if dtype == torch.float32 else field64
        w = torch.randn(8, generator=gen).to(dev, dtype)
        _, bi, bj = autotune_engine(N, N, N, a.element_size(), plan=plan)
        ms = cuda_time_ms(lambda: stencil_stream(a, w, plan, bi, bj, 1))
        plain_ms = cuda_time_ms(
            lambda: stencil_stream_plain(a, w, plan, 1), reps=3, warmup=1)
        pts = a.numel()
        bytes_bound = 2 * a.element_size() * pts / HBM_BYTES_PER_S * 1e3
        ops_bound = 2 * plan.spec.taps * pts / PEAK_FLOPS[dtype] * 1e3
        # conv3d is a cross-correlation: weight[d + r] scales u[x + d]
        wt = torch.zeros(3, 3, 3, device=dev, dtype=dtype)
        for (di, dj, dk), wi in zip(plan.spec.offsets, plan.spec.w_index):
            wt[di + 1, dj + 1, dk + 1] = w[wi]
        wt = wt.view(1, 1, 3, 3, 3)
        mask = ring_mask((N, N, N))

        def library():
            return torch.nn.functional.conv3d(a, wt, padding=1) * mask
        lib_out = library()
        err = max_abs(lib_out, stencil_stream(a, w, plan, bi, bj, 1))
        # 1e-3 in f32, scaled by the unit roundoff for f64
        lib_tol = 1e-3 * torch.finfo(dtype).eps / EPS32
        check(err < lib_tol, f"conv3d yardstick disagrees in {dtype}: "
              f"{err} >= {lib_tol}")
        library_ms = cuda_time_ms(library, reps=5, warmup=1)
        del lib_out
        row = {"name": "stencil_stream", "dtype": str(dtype)[6:],
               "shape": [1, N, N, N], "spec": "stencil27", "sweeps": 1,
               "block_i": bi, "block_j": bj, "ms": ms, "plain_ms": plain_ms,
               "bytes_bound_ms": bytes_bound, "ops_bound_ms": ops_bound,
               "library_ms": library_ms}
        times.append(row)
        if dtype == torch.float32:
            kernels.append({
                "name": "stencil_stream", "route": "cuda",
                "source": "src/repro_torch/kernels/stencil_engine/csrc/"
                          "stencil_stream.cu",
                "replaces": "src/repro/kernels/stencil_engine/kernel.py:496",
                "launches": launches["stencil_stream"],
                "max_abs_err": main_err["stencil_stream"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_bound, ops_bound),
                "bound_by": "bytes" if bytes_bound >= ops_bound
                            else "operations",
                "library_ms": library_ms})

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
                u = torch.nn.functional.conv1d(u, wt, padding=1) * kmask
            return u.view(rows, N)
        err = max_abs(library(), stencil_rows(a, w, plan3, br, sweeps))
        check(err < 1e-4, f"conv1d yardstick disagrees: {err}")
        library_ms = cuda_time_ms(library, reps=5, warmup=1)
        pts = a.numel()
        bytes_bound = 2 * 4 * pts / HBM_BYTES_PER_S * 1e3
        ops_bound = 2 * 3 * sweeps * pts / PEAK_FLOPS[torch.float32] * 1e3
        times.append({"name": "stencil_rows", "dtype": "float32",
                      "shape": [rows, N], "spec": "stencil3",
                      "sweeps": sweeps, "block_rows": br, "ms": ms,
                      "plain_ms": plain_ms, "bytes_bound_ms": bytes_bound,
                      "ops_bound_ms": ops_bound, "library_ms": library_ms})
        if rows == N * N:
            kernels.append({
                "name": "stencil_rows", "route": "cuda",
                "source": "src/repro_torch/kernels/stencil_engine/csrc/"
                          "stencil_rows.cu",
                "replaces": "src/repro/kernels/stencil_engine/kernel.py:766",
                "launches": launches["stencil_rows"],
                "max_abs_err": main_err["stencil_rows"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_bound, ops_bound),
                "bound_by": "bytes" if bytes_bound >= ops_bound
                            else "operations",
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
