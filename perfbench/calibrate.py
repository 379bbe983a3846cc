"""The readings a cell's limits are set from, in one process on the card:
the program's numbers on many seeds, and the control's on a few.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds <s>]

Each seed makes its own weights and serves the cell's own traffic for a
window (by default ``BENCHMARK.json``'s ``run_seconds``, so that each
seed compares as many sequences and positions as a benchmark run does),
then the check's sample is compared with the reference; on a control
seed the control is read at the same positions (``check.control_gap``). One JSON line a seed goes to
standard output. The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    import torch

    from perfbench import harness
    from perfbench.trace import Recorder
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seconds = args.seconds or harness._json(
        ROOT / "BENCHMARK.json")["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [s for s in controls if s not in seeds]:
        t0 = time.perf_counter()
        served = harness.serve_seed(cell, seed, seconds, "cuda:0",
                                    Recorder(False))
        line = harness.readings(cell, seed, "cuda:0", served,
                                control=seed in controls)
        line.update(workload=args.workload, seed=seed,
                    sequences=len(served["samples"]),
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
