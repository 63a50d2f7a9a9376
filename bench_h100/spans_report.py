"""Where a cell's device-idle time and syncs sit among the program's
spans, from one traced window on the card:

    python3 bench_h100/spans_report.py --workload <cell> --seed <n>

It runs the cell as `run.py --trace 1` does (its set-up, traced
window and check) and prints one JSON line: the traced window's units
and ms a unit, the cell's per-layer metrics, the device-idle ms a unit
split by the innermost program span the host was in
(`harness/spans.py` `idle_by_span`; "none" outside every span), and
the sync calls a unit by the host events that enclose each, outermost
first.  The benchmark's own runs never run this."""
from __future__ import annotations

import os

# as run.py: one host thread for torch's CPU work
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100.harness import program, spec  # noqa: E402
from bench_h100.harness import spans as S  # noqa: E402
from bench_h100.harness import trace as T  # noqa: E402
from bench_h100.harness.cell import WINDOW_RANGE  # noqa: E402
from bench_h100.reference.numerics import full_float32  # noqa: E402


def sync_chains(w: T.Window) -> Dict[str, int]:
    """Each sync call of the window by the names of the host events that
    enclose it, outermost first and joined by ">", counted."""
    events = sorted((s, e, n) for n, s, e in w.host
                    if n != WINDOW_RANGE and not S.SYNC_CALL.match(n))
    open_: List[Tuple[int, int, str]] = []  # (end, start, name), by end
    out: Dict[str, int] = {}
    i = 0
    for s, e in S.sync_calls(w):
        while i < len(events) and events[i][0] <= s:
            heapq.heappush(open_, (events[i][1], events[i][0], events[i][2]))
            i += 1
        while open_ and open_[0][0] < s:
            heapq.heappop(open_)
        chain = sorted((start, -end, name) for end, start, name in open_
                       if end >= e)
        key = ">".join(name for _, _, name in chain) or S.NO_SPAN
        out[key] = out.get(key, 0) + 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    program.cuda_lib.build()
    full_float32()
    dev = torch.device("cuda", 0)
    out = spec.driver(traffic["driver"]).run(
        cfg, traffic, args.seed, bench["run_seconds"], True, dev, t_start)
    w = out["window"]
    per_unit = 1e3 / w.units
    idle_ns = w.window_s * 1e9 - T.busy_ns(w)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0), "correct": out["correct"],
        "units": w.units, "window_s": w.window_s,
        "traced_ms_per_unit": w.window_s * per_unit,
        "idle_ms_per_unit": idle_ns / 1e9 * per_unit,
        "metrics": spec.read_metrics(bench, args.workload, "per_layer", w),
        "idle_ms_by_span": {n: ns / 1e9 * per_unit for n, ns in sorted(
            S.idle_by_span(w).items(), key=lambda kv: -kv[1])},
        "syncs_per_unit_by_chain": {k: n / w.units for k, n in sorted(
            sync_chains(w).items(), key=lambda kv: -kv[1])},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
