"""Popping detection, the temporal view-consistency evaluation
(counterpart of splatco_tpu/eval/popping.py).

Optical flow forward and backward between frames t and t+step, occlusion
by the forward-backward consistency test (Ruder et al., GCPR'16), frame t
warped onto t+step, and the occlusion-masked MSE and FLIP between the
warped frame and the actual one: for the render stream and, where given,
the ground-truth stream.  Popping shows as render-stream error above the
ground-truth stream's.

The flow estimator is a callable `flow(a, b) -> [H,W,2]` on [H,W,3]
frames in [0,1]: OpenCV's Farneback by default (on the host; needs
OpenCV), or RAFT (eval/raft.py `make_flow_fn`) with local weights.  The
warps, the occlusion test and FLIP run in torch on the frames' device.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from splatco_torch.data.images import read_image
from splatco_torch.ops.flip import ldr_flip_error_map
from splatco_torch.utils.device import resolve_device

FlowFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def flow_farneback(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense optical flow a->b by OpenCV's Farneback on the host; frames
    [H,W,3] in [0,1]; returns [H,W,2] float32 on a's device."""
    import cv2

    def grey(x):
        return cv2.cvtColor((x.cpu().numpy() * 255).astype(np.uint8),
                            cv2.COLOR_RGB2GRAY)

    flow = cv2.calcOpticalFlowFarneback(
        grey(a), grey(b), None, pyr_scale=0.5, levels=4, winsize=21,
        iterations=3, poly_n=7, poly_sigma=1.5, flags=0)
    return torch.from_numpy(flow).to(a.device)


def _sample(img: torch.Tensor, mx: torch.Tensor,
            my: torch.Tensor) -> torch.Tensor:
    """img [H,W,C] at pixel coordinates (mx, my) [H,W], bilinear, each of
    the four taps clamped to the image (the border's pixels repeat)."""
    h, w = img.shape[:2]
    # a coordinate beyond [-1, size] samples the edge pixel as -1 or size
    # does; clamping first keeps the integer taps in range
    mx = torch.clamp(mx, -1.0, float(w))
    my = torch.clamp(my, -1.0, float(h))
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = (mx - x0)[..., None]
    fy = (my - y0)[..., None]
    xa = torch.clamp(x0.long(), 0, w - 1)
    xb = torch.clamp(x0.long() + 1, 0, w - 1)
    ya = torch.clamp(y0.long(), 0, h - 1)
    yb = torch.clamp(y0.long() + 1, 0, h - 1)
    img = img.to(torch.float32)
    return ((img[ya, xa] * (1 - fx) + img[ya, xb] * fx) * (1 - fy)
            + (img[yb, xa] * (1 - fx) + img[yb, xb] * fx) * fy)


def _targets(flow: torch.Tensor):
    """x + flow(x): the sample coordinates [H,W] of a backward warp."""
    h, w = flow.shape[:2]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij")
    return gx + flow[..., 0], gy + flow[..., 1]


def warp_with_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: out(x) = img(x + flow(x)), bilinear, each tap
    clamped to the image, as cv2.remap(INTER_LINEAR, BORDER_REPLICATE)
    samples a one-, three- or four-channel image; img [H,W,C], flow
    [H,W,2]."""
    return _sample(img, *_targets(flow))


# cv2.remap samples a two-channel image, such as a flow field, at
# coordinates rounded to 1/32 px (OpenCV's INTER_TAB_SIZE; its one-,
# three- and four-channel paths sample exactly), and the JAX package's
# occlusion test warps the backward flow with it
_FLOW_WARP_STEPS = 32


def detect_occlusion(flow_fwd: torch.Tensor,
                     flow_bwd: torch.Tensor) -> torch.Tensor:
    """[H,W] mask, True where a pixel is valid (not occluded), by the
    forward-backward consistency test of Ruder et al.: the backward flow
    is sampled at x + flow_fwd(x) rounded to 1/32 px, as cv2.remap
    samples a two-channel image."""
    q = _FLOW_WARP_STEPS
    mx, my = _targets(flow_fwd)
    bwd_warped = _sample(flow_bwd, torch.round(mx * q) / q,
                         torch.round(my * q) / q)
    fb = flow_fwd + bwd_warped
    fb_mag = (fb ** 2).sum(-1)
    mag = (flow_fwd ** 2).sum(-1) + (bwd_warped ** 2).sum(-1)
    occluded = fb_mag > 0.01 * mag + 0.5
    return ~occluded


def frame_popping_error(prev: torch.Tensor, cur: torch.Tensor,
                        flow_fn: FlowFn = flow_farneback) -> Dict:
    """Masked MSE and FLIP between prev warped onto cur and cur ([H,W,3]),
    and the share of valid pixels."""
    with torch.inference_mode():
        fwd = flow_fn(cur, prev)   # cur -> prev: the backward warp field
        bwd = flow_fn(prev, cur)
        valid = detect_occlusion(fwd, bwd)
        warped = warp_with_flow(prev, fwd)
        diff = ((warped - cur) ** 2).mean(-1)
        n_valid = max(int(valid.sum()), 1)
        mse = float((diff * valid).sum()) / n_valid
        flip_map = ldr_flip_error_map(warped.permute(2, 0, 1),
                                      cur.permute(2, 0, 1))
        flip = float((flip_map * valid).sum()) / n_valid
        return {"mse": mse, "flip": flip,
                "valid_frac": float(valid.float().mean())}


def plot_popping(results: Dict, out_dir: str) -> None:
    """Per-frame MSE/FLIP curves, one figure per step (render in red, gt
    in green), as test_all_step_<step>.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for key, res in results.items():
        step = key.split("_")[-1]
        frames = res["frames"]
        xs = [e["frame"] for e in frames]
        fig, axes = plt.subplots(1, 2, figsize=(16, 9))
        fig.suptitle(f"Metrics, step = {step}")
        for ax, metric in zip(axes, ("mse", "flip")):
            ax.set_title(metric.upper())
            ax.plot(xs, [e["render"][metric] for e in frames],
                    color="red", label="render", alpha=0.75)
            if frames and "gt" in frames[0]:
                ax.plot(xs, [e["gt"][metric] for e in frames],
                        color="green", label="gt", alpha=0.75)
            ax.legend()
        fig.savefig(os.path.join(out_dir, f"test_all_step_{step}.png"),
                    bbox_inches="tight")
        plt.close(fig)


def load_frames(frame_dir: str, device) -> List[torch.Tensor]:
    """The .png/.jpg frames of a directory in name order, as [H,W,3]
    float32 tensors in [0,1] on `device`."""
    frames = []
    for f in sorted(os.listdir(frame_dir)):
        if f.lower().endswith((".png", ".jpg")):
            pixels = np.float32(read_image(os.path.join(frame_dir, f)))
            frames.append(torch.as_tensor(pixels[..., :3] / 255.0,
                                          device=device))
    return frames


def validate_popping(render_dir: str, gt_dir: Optional[str] = None,
                     steps: tuple = (1, 7),
                     flow_fn: FlowFn = flow_farneback,
                     out_json: Optional[str] = None,
                     plot_dir: Optional[str] = None, device=None) -> Dict:
    """Temporal consistency of an ordered frame directory (and, for
    calibration, of a ground-truth stream) on `device` (None: the card):
    per step, each frame pair's scores and their means."""
    dev = resolve_device(device)
    renders = load_frames(render_dir, dev)
    gts = load_frames(gt_dir, dev) if gt_dir else None
    results = {}
    for step in steps:
        per_frame = []
        for t in range(len(renders) - step):
            entry = {"frame": t}
            entry["render"] = frame_popping_error(renders[t],
                                                  renders[t + step], flow_fn)
            if gts:
                entry["gt"] = frame_popping_error(gts[t], gts[t + step],
                                                  flow_fn)
            per_frame.append(entry)
        agg = {
            "mean_mse": float(np.mean([e["render"]["mse"]
                                       for e in per_frame])),
            "mean_flip": float(np.mean([e["render"]["flip"]
                                        for e in per_frame])),
        }
        if gts:
            agg["gt_mean_mse"] = float(np.mean([e["gt"]["mse"]
                                                for e in per_frame]))
            agg["gt_mean_flip"] = float(np.mean([e["gt"]["flip"]
                                                 for e in per_frame]))
        results[f"step_{step}"] = {"aggregate": agg, "frames": per_frame}
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(results, fh, indent=2)
    if plot_dir:
        plot_popping(results, plot_dir)
    return results
