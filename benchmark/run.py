"""The benchmark of the PyTorch/CUDA port, one cell a run::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  Prints the result as the last line of standard output, and the
numbers the correctness check compared, each beside its limit, as the
last lines of standard error.  Without a card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded after the window, it
exits nonzero and prints no result.  ``BENCHMARK.json`` lists the cells;
``benchmark/harness.py`` says what a run does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache of the program at a fixed place in the
# checkout (the CUDA kernels build into build/kernels by themselves).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "nv_compute_cache")
# One host thread for the CPU-side work: fewer threads contend less with
# whatever else shares the host's cores.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    try:
        rec = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    except harness.RunError as e:
        print(f"error: {e}", file=sys.stderr)
        return e.code
    harness.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
