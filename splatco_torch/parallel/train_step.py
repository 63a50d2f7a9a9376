"""The sharded SVC training step over a (view, gauss) mesh of ranks
(counterpart of splatco_tpu/parallel/train_step.py).

Each rank runs one summand of the global loss (parallel/mesh.py for the
layout):
  * its view row's view, its gauss column's anchor shard: the anchors are
    prefiltered with the view's true geometry and decoded with BatchNorm
    statistics summed over gauss,
  * the decoded gaussians are gathered over gauss and projected; the rank
    rasterizes its horizontal strip of the view (means shifted up by
    gauss * strip height; the tile kernels or the dense compositor), and
    the strips are gathered back into the view for the losses,
  * the views are gathered over view for the consistency term,
  * local = per_view / n_gauss + 0.05 * con / (n_view * n_gauss)
            + tv / (n_view * n_gauss),
so the sum over ranks is the single-device loss.  Each rank takes the
gradient of its own summand; the gathers' backwards sum the cotangents
back onto each shard (parallel/collectives.py), the anchor gradients are
then summed over view and every other gradient over the world, and the
Adam step runs on every rank on identical (replicated) or its own
(sharded) leaves.

The densification statistics follow the reference's last-view quirk: the
screen-space "viewspace proxy" gradient of the full view is the sum over
gauss of each strip's; each rank keeps its anchors' slice; only the last
view row adds, and a sum over view hands every rank the same update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.models.renderer import (BACKENDS, generate_neural_gaussians,
                                           rasterize_backend)
from splatco_torch.models.splatco import decode_kwargs
from splatco_torch.models.triplane import tv_loss
from splatco_torch.ops.losses import masked_ssim
from splatco_torch.ops.projection import (project_gaussians,
                                          visible_radius_mask)
from splatco_torch.parallel.collectives import (all_gather, all_reduce_sum,
                                                fold_sum, gather_parts)
from splatco_torch.parallel.mesh import Mesh
from splatco_torch.train.optimizer import Optimizer, tree_leaves, tree_map
from splatco_torch.train.step import TrainStats
from splatco_torch.utils.device import resolve_device
from splatco_torch.utils.math import normalize

# the decoded gaussians' columns gathered over gauss in one collective:
# xyz, color, opacity, scaling, rot, selection mask
_COLS = (("xyz", 3), ("color", 3), ("opacity", 1), ("scaling", 3),
         ("rot", 4), ("mask", 1))


def pad_view_batch(cams, gts: Sequence[torch.Tensor], n_gauss: int,
                   tile: int = 32):
    """A mixed-resolution SVC batch as one padded canvas: its height a
    multiple of n_gauss * tile (every strip whole tiles), its width of
    tile.  Returns (cameras with the canvas size and view 0's fov, gts
    zero-padded [V, 3, Hp, Wp], view_geom [V, 4] float64 on the CPU = each
    view's true (h, w, tan_fovx, tan_fovy)).  The step projects with the
    true geometry and masks the losses to each view's true window, so the
    pixel mapping is unchanged; splats may spill into the masked pad."""
    quant = n_gauss * tile
    hp = -(-max(c.image_height for c in cams) // quant) * quant
    wp = -(-max(c.image_width for c in cams) // tile) * tile
    view_geom = torch.tensor(
        [[c.image_height, c.image_width, c.tan_fovx, c.tan_fovy]
         for c in cams], dtype=torch.float64)
    gts_p = torch.stack([
        torch.nn.functional.pad(g, (0, wp - g.shape[-1], 0, hp - g.shape[-2]))
        for g in gts])
    cams_p = [dataclasses.replace(c, image_height=hp, image_width=wp,
                                  fovx=cams[0].fovx, fovy=cams[0].fovy)
              for c in cams]
    return cams_p, gts_p, view_geom


def view_seed(seed: int, view: int) -> int:
    """The q-noise generator's seed of `view` in a step seeded `seed`."""
    return int(np.random.SeedSequence([seed, view]).generate_state(1)[0])


def make_sharded_train_step(cfg: ModelConfig, opt: OptimizationConfig,
                            mesh: Mesh, tx: Optimizer,
                            activate_level: int = 0, backend: str = "cuda",
                            q_noise: float = 0.03,
                            device=None) -> Callable:
    """This rank's SVC step on `mesh` at a fixed activate_level, with the
    optimizer `tx` (built from the params' structure), on `device`
    (default the card).  `backend` is "cuda" (the tile kernels, in the
    configuration the SPLATCO_RASTER switch picks) or "dense".

    step(params, opt_state, active, contractor, stats, cam, gt, seed,
         consistency_on, tv_w, stats_on, view_geom=None)
        -> (params, opt_state, stats, metrics)

    params / opt_state / active / stats are this rank's: the anchors
    sliced to its gauss block (mesh.shard_params), the rest replicated.
    cam and gt [3, H, W] are its view's, every view on one canvas whose H
    divides by n_gauss (pad_view_batch); view_geom [V, 4] holds every
    view's true (h, w, tan_fovx, tan_fovy), None meaning every view fills
    the canvas.  The q-noise of a view is drawn from a generator seeded
    by (seed, view).  metrics: loss (the global loss), l1 (mean over the
    ranks), con, num_overflow (0), max_slots (max over the ranks),
    num_clipped (summed) and num_clipped_strips (each rank's, in rank
    order).  The inputs are not modified."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = resolve_device(device)
    dkw = decode_kwargs(cfg)
    lam = opt.lambda_dssim
    k = cfg.n_offsets
    nv, ng = mesh.n_view, mesh.n_gauss
    vidx, gidx = mesh.view, mesh.gauss
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32, device=dev)

    def masks(geom, h: int, w: int) -> List[torch.Tensor]:
        rows = torch.arange(h, device=dev)[:, None]
        cols = torch.arange(w, device=dev)[None, :]
        return [(rows < int(g[0])) & (cols < int(g[1])) for g in geom]

    def device_loss(leaves, proxy, active, contractor, cam, gt, generator,
                    geom, consistency_on, tv_w):
        h, w = cam.image_height, cam.image_width
        h_strip = h // ng
        th, tw, tfx, tfy = geom[vidx]
        view_masks = masks(geom, h, w)
        mask = view_masks[vidx]

        # the anchor prefilter with the view's true geometry
        anch = leaves["anchors"]
        with torch.no_grad():
            pre = visible_radius_mask(
                anch["anchor"], torch.exp(anch["scaling"])[:, :3],
                normalize(anch["rotation"], eps=1e-12),
                cam.world_view_transform, cam.full_proj_transform, tw, th,
                tfx, tfy)
        vis = pre & active
        g = generate_neural_gaussians(
            leaves, contractor, cam, vis, activate_level=activate_level,
            q_noise=q_noise, generator=generator, group=mesh.gauss_group,
            **dkw)

        local_cols = torch.cat(
            [g["xyz"], g["color"], g["opacity"][:, None], g["scaling"],
             g["rot"], g["mask"].to(torch.float32)[:, None]], dim=1)
        cols = dict(zip([n for n, _ in _COLS], torch.split(
            all_gather(local_cols, mesh.gauss_group, dim=0),
            [d for _, d in _COLS], dim=1)))
        opacity = cols["opacity"][:, 0]
        sel = cols["mask"][:, 0].detach()

        # projected with the true view size (the NDC -> pixel map must not
        # see the padded canvas), then shifted into this strip's frame;
        # the proxy rides on the global screen-space means
        proj = project_gaussians(cols["xyz"], cols["scaling"], cols["rot"],
                                 cam.world_view_transform,
                                 cam.full_proj_transform, tw, th, tfx, tfy)
        radius = torch.where(opacity > 0.0, proj.radius, 0.0)
        sproj = proj._replace(
            mx=proj.mx + proxy[:, 0],
            my=proj.my + proxy[:, 1] - float(gidx * h_strip),
            radius=radius)
        strip, aux = rasterize_backend(backend, sproj, cols["color"], opacity,
                                       bg, h_strip, w, cfg.kmax)
        image = all_gather(strip, mesh.gauss_group, dim=1) * mask[None]

        npix = 3.0 * th * tw
        ll1 = (image - gt).abs().sum() / npix
        ssim_l = 1.0 - masked_ssim(image, gt, mask)
        sreg = ((torch.prod(cols["scaling"], dim=1) * sel).sum()
                / torch.clamp_min(sel.sum(), 1.0))
        per_view = (1.0 - lam) * ll1 + lam * ssim_l + 0.01 * sreg

        # the consistency term over every view pair: each rank computes
        # the whole sum from the gathered views, divided so that the sum
        # over ranks counts it once
        imgs = all_gather(image[None], mesh.view_group, dim=0)
        with torch.no_grad():
            gts = all_gather(gt[None], mesh.view_group, dim=0)
        con = torch.zeros((), device=dev)
        for i in range(nv):
            for j in range(i + 1, nv):
                pm = view_masks[i] & view_masks[j]
                pnpix = torch.clamp_min(3.0 * pm.sum(), 1.0)
                gate = masked_ssim(gts[i], gts[j], pm)
                diff = ((gts[i] - gts[j]) - (imgs[i] - imgs[j])).abs()
                diff = (diff * pm[None]).sum() / pnpix
                con = con + torch.where(gate > 0.6, gate * diff.abs(), 0.0)

        local = (per_view / ng + consistency_on * 0.05 * con / (nv * ng)
                 + tv_loss(leaves["planes"], 1.0, activate_level) * tv_w
                 / (nv * ng))
        return local, {"ll1": ll1, "con": con, "vis": vis, "g": g,
                       "radius": radius.detach(), "aux": aux}

    def reduce_grads(grads, group):
        """Sum a tree of gradients over `group`, flattened into one
        buffer (one collective)."""
        leaves = tree_leaves(grads)
        flat = all_reduce_sum(torch.cat([x.reshape(-1) for x in leaves]),
                              group)
        out = iter(torch.split(flat, [x.numel() for x in leaves]))
        return tree_map(lambda x: next(out).view_as(x), grads)

    def step(params, opt_state, active: torch.Tensor, contractor,
             stats: TrainStats, cam, gt: torch.Tensor, seed: int,
             consistency_on, tv_w, stats_on, view_geom=None):
        if cam.image_height % ng:
            raise ValueError(f"canvas height {cam.image_height} does not "
                             f"divide over {ng} strips (pad_view_batch)")
        if view_geom is None:
            geom = [(cam.image_height, cam.image_width, cam.tan_fovx,
                     cam.tan_fovy)] * nv
        else:
            geom = [tuple(float(v) for v in row)
                    for row in torch.as_tensor(view_geom).tolist()]
        generator = (torch.Generator(device=dev).manual_seed(
            view_seed(seed, vidx)) if q_noise > 0.0 else None)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        c_local = leaves["anchors"]["anchor"].shape[0]
        proxy = torch.zeros((c_local * ng * k, 2), device=dev,
                            requires_grad=True)
        local, aux = device_loss(leaves, proxy, active, contractor, cam, gt,
                                 generator, geom, consistency_on, tv_w)

        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(local, flat + [proxy],
                                    allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for p, g in zip(flat + [proxy], grads)]
        proxy_grad = grads[-1]
        it = iter(grads[:-1])
        grads = tree_map(lambda _: next(it), leaves)

        with torch.no_grad():
            # anchor gradients over view only: the gathers' backwards
            # already summed them over gauss
            grads = dict(
                reduce_grads({n: v for n, v in grads.items()
                              if n != "anchors"}, mesh.world),
                anchors=reduce_grads(grads["anchors"], mesh.view_group))

            # densification statistics: the full view's screen gradient,
            # this rank's anchors' slice, the last view row only
            lo, n_loc = gidx * c_local * k, c_local * k
            screen = all_reduce_sum(proxy_grad, mesh.gauss_group)[
                lo:lo + n_loc]
            radius_local = aux["radius"][lo:lo + n_loc]
            gate = stats_on * (1.0 if vidx == nv - 1 else 0.0)
            g = aux["g"]
            vis_anchor = aux["vis"][:, None]
            neur_op = torch.clamp_min(g["neural_opacity"].detach(),
                                      0.0).reshape(c_local, k)
            slot_mask = (g["mask"] & (radius_local > 0))[:, None]
            th, tw = geom[vidx][0], geom[vidx][1]
            gscale = torch.tensor([0.5 * tw, 0.5 * th], dtype=torch.float32,
                                  device=dev)
            gnorm = torch.linalg.vector_norm(screen * gscale, dim=-1,
                                             keepdim=True)
            deltas = [gate * torch.where(vis_anchor,
                                         neur_op.sum(dim=1, keepdim=True),
                                         0.0),
                      gate * torch.where(vis_anchor, 1.0, 0.0),
                      gate * torch.where(slot_mask, gnorm, 0.0),
                      gate * torch.where(slot_mask, 1.0, 0.0)]
            summed = torch.split(
                all_reduce_sum(torch.cat(deltas), mesh.view_group),
                [d.shape[0] for d in deltas])
            stats = TrainStats(
                opacity_accum=stats.opacity_accum + summed[0],
                anchor_demon=stats.anchor_demon + summed[1],
                offset_gradient_accum=stats.offset_gradient_accum
                + summed[2],
                offset_denom=stats.offset_denom + summed[3])

            # the metrics of every rank, in one gather: the loss is the
            # sum of the summands, l1 their mean (psum, pmean, pmax)
            raux = aux["aux"]
            parts = gather_parts(torch.stack([
                local.detach(), aux["ll1"].detach(), aux["con"].detach(),
                raux["num_clipped"].to(torch.float32),
                raux["max_slots"].to(torch.float32)]), mesh.world,
                "metrics")
            clipped = torch.stack([p[3] for p in parts]).to(torch.int64)

        new_params, opt_state = tx.update(grads, opt_state, params)
        metrics: Dict[str, Any] = {
            "loss": fold_sum([p[0] for p in parts]),
            "l1": fold_sum([p[1] for p in parts]) / mesh.world.size,
            "con": aux["con"].detach(),
            "num_overflow": 0,
            "max_slots": torch.stack([p[4] for p in parts]).amax().to(
                torch.int64),
            "num_clipped": clipped.sum(),
            "num_clipped_strips": clipped,
        }
        return new_params, opt_state, stats, metrics

    return step

