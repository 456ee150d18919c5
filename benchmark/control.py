"""Readings that set the limits of a cell's check, on the card at the
cell's own size::

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        --fault half_batch

Without ``--fault``: the control, the plain reference in TF32 (the
precision below float32 with TF32 off) put in the program's place and
compared with the float32 reference.  With ``--fault``: a whole run of
the program with that fault planted (``faults.py``), over a one-second
window.  Prints one JSON line per seed with the compared numbers.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse
    import importlib

    from benchmark import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    dev = harness.require_cards(1)
    spec = harness.load_cell(args.workload)
    if args.fault:
        faults.plant(args.fault)
    drivers = importlib.import_module(
        f"benchmark.drivers.{spec['mix']['driver']}")
    for seed in args.seeds:
        t = time.perf_counter()
        if args.fault:
            rec = harness.run(args.workload, seed, 1.0, False, t, device=dev)
            checks = rec["checks"]
        else:
            drv = drivers.Driver(spec["cfg"], spec["mix"], seed, dev)
            ref = drv.reference_outputs()
            ctl = drv.reference_outputs(tf32=True)
            checks = {n: {"value": v, "limit": lim} for n, v, lim in
                      drv.compare(ctl, ref, spec["mix"]["limits"])}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control_tf32",
                          "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
