"""Time the streaming stencil kernel over its block shapes on the card.

    python3 scripts/stream_block_sweep.py [--n 512] [--specs stencil27,...]

For each spec and dtype, on a (1, n, n, n) field: one sweep of
``stencil_stream`` at every (block_i, block_j) the block chooser considers,
timed with CUDA events after a warm-up, beside the chooser's pick and the
j-tile height it prefers.  The table is what ``autotune.py``'s
``preferred_block_j`` was read from; rerun it after changing the kernel.
Needs a CUDA device; prints one JSON line per case and the card's name and
power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--specs", default="stencil27,stencil7,box125,star13")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stream_block_sweep: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.stencil_engine import (autotune_engine,
                                                    build_kernels,
                                                    compile_plan,
                                                    stencil_stream)
    from repro_torch.kernels.stencil_engine.autotune import (
        BLOCK_J_CANDIDATES, preferred_block_j)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    build_kernels()
    n = args.n
    gen = torch.Generator(device="cpu").manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for dtype in (torch.float32, torch.float64):
        a = torch.randn((1, n, n, n), generator=gen).to("cuda", dtype)
        for name in args.specs.split(","):
            plan = compile_plan(name)
            w = torch.randn(plan.spec.n_weights, generator=gen).to(
                "cuda", dtype)
            _, pbi, pbj = autotune_engine(n, n, n, a.element_size(),
                                          plan=plan)
            for bj in BLOCK_J_CANDIDATES:
                # the chooser's block_i for this tile height
                _, bi, _ = autotune_engine(n, n, n, a.element_size(),
                                           plan=plan, block_j=bj)
                def run():
                    return stencil_stream(a, w, plan, bi, bj, 1)
                for _ in range(3):
                    run()
                start.record()
                for _ in range(args.reps):
                    run()
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({
                    "spec": name, "dtype": str(dtype)[6:], "n": n,
                    "block_i": bi, "block_j": bj,
                    "ms": start.elapsed_time(end) / args.reps,
                    "preferred_block_j": preferred_block_j(
                        a.element_size(), plan.spec.taps),
                    "chosen": (bi, bj) == (pbi, pbj)}))
        del a


if __name__ == "__main__":
    main()
