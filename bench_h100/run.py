"""Runs one cell of the H100 benchmark of splatco_torch once, on the card
of the machine it starts on:

    python3 bench_h100/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  It prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device,
with --trace 1 breakdown, and last "checks": each compared number beside
its limit, which are also the last lines of standard error.  It exits
with another code than 0 and prints no result where there is no card,
fewer cards than the cell asks for, the program is missing, or a module
of JAX or of the JAX package was loaded.

Build and compile caches stay inside the checkout: the kernels'
libraries in splatco_torch/_build/, the rest under bench_h100/.cache/.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench_h100" / ".cache"
# one process with one host thread for torch's CPU work: the step's host
# side is the loop's bottleneck, and idle OpenMP workers that spin take
# its cores
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cell, spec
    torch.set_num_threads(1)

    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
              f"{w['chips']}", file=sys.stderr)
        return 2
    from bench_h100.harness import program
    program.cuda_lib.build()
    dev = torch.device("cuda", 0)
    res = cell.execute(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), dev, T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"], "memory_peak_bytes": int(res["peak"])}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res["checks"]}
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, v, lim in res["checks"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
