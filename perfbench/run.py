"""The benchmark's command: one run of one cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Every build and kernel cache is kept in
fixed directories under ``build/`` there. Exits non-zero, printing no
result, without enough CUDA cards or if the process loaded JAX or the
JAX package.
"""
import time

T_PROCESS = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
