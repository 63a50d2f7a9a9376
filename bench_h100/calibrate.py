"""The readings the correctness limits are set from, on the card at a
cell's own size:

    python3 bench_h100/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--faults half_batch altered] [--control]

For each seed it prints one JSON line with the numbers the check
compares, against the float32 reference, for: the program ("program",
a sound run's lower reading), with --control the reference computed
as TF32 tensor cores compute its products, forward and backward, in the
program's place ("control"), and each planted fault (harness/faults.py),
by the cell's driver (drivers/<driver>.py `readings`).  The benchmark's
own runs never run this."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.harness import program, spec  # noqa: E402
from bench_h100.harness.cell import free  # noqa: E402
from bench_h100.reference.numerics import full_float32  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, args.workload)
    cfg = spec.config(bench, w["config"])
    traffic = spec.traffic(w["traffic"])
    program.cuda_lib.build()
    full_float32()
    dev = torch.device("cuda", 0)
    read = spec.driver(traffic["driver"]).readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = read(cfg, traffic, seed, dev, args.control, args.faults)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
        free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
