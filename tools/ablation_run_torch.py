#!/usr/bin/env python
"""Ablation of the three SplatCo mechanisms with the PyTorch/CUDA port
(counterpart of tools/ablation_run.py, whose payload it writes): four
short training runs with one seed and configuration on one scene,
through tools/quality_run_torch.py's `main` -- baseline, without the
CSCM plane levels (no_multilevel), without the SVC consistency loss
(no_consistency) and without CVPM pruning (no_cvpm) -- and the final test
metrics of each beside its deltas to the baseline.

    python3 tools/ablation_run_torch.py --iterations 2000 --hard \\
        --out ABLATION_torch.json [--device cpu]

The scene, each variant's model and its quality-run payload go under
--work.  The payload is rewritten after each variant, so a run cut short
keeps the variants it finished.  Runs on the card unless --device cpu is
given."""
import argparse
import json
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)

import quality_run_torch  # noqa: E402

VARIANTS = {
    "baseline": [],
    "no_multilevel": ["--no_multilevel"],
    "no_consistency": ["--no_consistency"],
    "no_cvpm": ["--no_cvpm"],
}


def with_deltas(results: dict) -> dict:
    """Each variant's delta_vs_baseline = baseline - ablated, per metric
    (PSNR/SSIM: positive means the mechanism helps; FLIP, lower is
    better: negative means it helps)."""
    if "baseline" in results:
        base = results["baseline"]["final_test"]
        for name, res in results.items():
            if name != "baseline":
                res["delta_vs_baseline"] = {
                    k: round(base[k] - v, 4)
                    for k, v in res["final_test"].items()}
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--work", default="ablation_work",
                    help="directory of the scene, the models and the "
                    "variants' payloads")
    ap.add_argument("--out", default="ABLATION_torch.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--views", type=int, default=28)
    ap.add_argument("--points", type=int, default=1200)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--arc_period", type=int, default=3)
    ap.add_argument("--hard", action="store_true",
                    help="run the ablations on the hard protocol's scene "
                    "(sparse init, close-in cameras), where CVPM and "
                    "densification are active")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma list, run in order")
    args = ap.parse_args(argv)

    scene = os.path.join(args.work, "scene")
    results = {}
    payload = None
    for name in (n for n in args.variants.split(",") if n):
        out_json = os.path.join(args.work, f"ablation_{name}.json")
        argv_run = [
            "--iterations", str(args.iterations), "--scene", scene,
            "--model", os.path.join(args.work, f"out_{name}"),
            "--out", out_json, "--device", args.device,
            "--views", str(args.views), "--points", str(args.points),
            "--width", str(args.width), "--height", str(args.height),
            "--skip_artifacts", "--arc_period", str(args.arc_period),
        ] + VARIANTS[name] + (["--hard"] if args.hard else [])
        print(f"=== ablation variant: {name} ===", flush=True)
        run = quality_run_torch.main(argv_run)
        results[name] = {
            "final_test": run["final_test"],
            "anchors_final": run["anchors_final"],
            "wall_seconds": run["wall_seconds"],
        }
        # what the mechanisms did in this variant
        ev = [e for e in run["trajectory"] if "densify_grown" in e]
        if ev:
            results[name]["dynamics"] = {
                "grown": sum(e["densify_grown"] for e in ev),
                "pruned": sum(e["densify_pruned"] for e in ev),
                "cvpm_marked": sum(e.get("cvpm_marked", 0) for e in ev),
            }
        payload = {
            "config": {"iterations": args.iterations,
                       "views": args.views, "points": args.points,
                       "resolution": [args.height, args.width],
                       "backend": run["config"]["backend"], "seed": 0,
                       "hard_protocol": args.hard},
            "note": ("delta_vs_baseline = baseline - ablated, per "
                     "metric; positive PSNR/SSIM delta (or negative "
                     "FLIP delta) means removing the mechanism hurt, "
                     "i.e. the mechanism helps"),
            "variants": with_deltas(results),
        }
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2)
    print(json.dumps(payload["variants"], indent=1))
    return payload


if __name__ == "__main__":
    main()
