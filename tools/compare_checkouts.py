"""Time the port's kernels in two checkouts, in turns, on one card.

    python3 tools/compare_checkouts.py PARENT CHANGE [--rounds 1]

PARENT and CHANGE are roots of two checkouts of this repository (for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``).  Each round runs PARENT, CHANGE, CHANGE, PARENT,
each in a process of its own that builds that checkout's kernels and times,
with CUDA events over 20 launches after a warm-up, the clamp main path at
512^3: ``stencil_stream`` for stencil27 and star13, one sweep, in f32 and
f64 at the block chooser's blocks, and ``stencil_rows`` for stencil3 on
262,144 rows of 512, two sweeps.  Prints the card's name and power limit,
then one JSON line per process.  Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

N = 512
REPS = 20

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels.stencil_engine import (autotune_engine,
    build_kernels, compile_plan, pick_block_rows, stencil_rows,
    stencil_stream)
build_kernels()
N, REPS = int(sys.argv[2]), int(sys.argv[3])

def ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS

gen = torch.Generator(device="cuda").manual_seed(0)
out = {"root": sys.argv[1]}
for dtype in (torch.float32, torch.float64):
    a = torch.randn((1, N, N, N), generator=gen, device="cuda", dtype=dtype)
    for name in ("stencil27", "star13"):
        plan = compile_plan(name)
        w = torch.randn(plan.spec.n_weights, generator=gen, device="cuda",
                        dtype=dtype)
        _, bi, bj = autotune_engine(N, N, N, a.element_size(), plan=plan)
        out[f"{name}_{str(dtype)[6:]}"] = ms(
            lambda: stencil_stream(a, w, plan, bi, bj, 1))
    del a
a = torch.randn((N * N, N), generator=gen, device="cuda")
w = torch.randn(2, generator=gen, device="cuda")
plan = compile_plan("stencil3")
br = pick_block_rows(N * N, N, 4)
out["stencil3_float32_2_sweeps"] = ms(lambda: stencil_rows(a, w, plan, br, 2))
print(json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    order = [args.parent, args.change, args.change, args.parent]
    for _ in range(args.rounds):
        for root in order:
            run = subprocess.run(
                [sys.executable, "-c", CHILD, os.path.abspath(root), str(N),
                 str(REPS)], capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                sys.exit(f"compare_checkouts: {root} failed:\n{run.stderr}")
            print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
