"""The work each camera's frame needs, counted by the reference on the
cell's inputs (never by the program): visible anchors, gaussians with
opacity > 0, (tile, gaussian) records, and the blend's pixel
evaluations up to termination, those that pass the alpha test, and the
contributions.  counts/ turns them into bounds and operations."""
from __future__ import annotations

from typing import Dict, List

import torch

from bench_h100.reference.numerics import Numerics
from bench_h100.reference.project import project, visible
from bench_h100.reference import model as rm
from bench_h100.reference.raster import bin_records, blend_fwd


def camera_counts(params, bounds, cams, active: torch.Tensor, level: int,
                  tile: int, kmax: int) -> List[Dict]:
    num = Numerics("fp32")
    out = []
    with torch.no_grad():
        for cam in cams:
            vis = visible(params["anchors"], active, cam)
            g = rm.decode(params, bounds[0], bounds[1], cam.center, vis,
                          level, num)
            cols = project(g["xyz"], g["scaling"], g["rot"], cam)
            cols = cols._replace(radius=torch.where(g["opacity"] > 0.0,
                                                    cols.radius, 0.0))
            b = bin_records(cols, g["color"], g["opacity"], cam.width,
                            cam.height, tile, kmax)
            work: Dict = {}
            blend_fwd(b, cam.width, cam.height, work)
            work.update(visible_anchors=int(vis.sum()),
                        gaussians=int(g["mask"].sum()),
                        tiles=b.tiles_x * b.tiles_y,
                        pixels=b.tiles_x * b.tiles_y * tile * tile,
                        image_pixels=cam.width * cam.height)
            out.append(work)
    return out
