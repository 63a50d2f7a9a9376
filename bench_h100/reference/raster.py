"""The reference's tile rasterizer: each gaussian's tile rect clipped to
`kmax` tiles around its centre, the exact ellipse-reach test per tile,
records in (tile, depth) order, and the alpha blend with its contract
(alpha <= 0.99, skip alpha < 1/255, stop where T (1 - alpha) < 1e-4,
pixel centres on integer coordinates), forward and backward, vectorised
over tiles and pixels and serial over each tile's records.  The blend
also counts its work: pixel evaluations up to termination, the ones that
pass the alpha test, and the contributions."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
OP_MIN = 1e-12


class Binned(NamedTuple):
    records: torch.Tensor     # [9, P]: mx, my, ca, cb, cc, op, r, g, b
    gauss_id: torch.Tensor    # [P] int64
    tile_start: torch.Tensor  # [T] int64
    tile_end: torch.Tensor    # [T] int64
    tiles_x: int
    tiles_y: int
    tile: int
    num_clipped: int


def _rects(mx, my, rad, tile: int, tiles_x: int, tiles_y: int, kmax: int):
    i32 = torch.int32

    def span(c, fn, n):
        return torch.clamp(fn(c / tile), 0, n).to(i32)

    x0, y0 = span(mx - rad, torch.floor, tiles_x), span(my - rad, torch.floor,
                                                          tiles_y)
    x1, y1 = span(mx + rad, torch.ceil, tiles_x), span(my + rad, torch.ceil,
                                                         tiles_y)
    sx, sy = torch.clamp_min(x1 - x0, 0), torch.clamp_min(y1 - y0, 0)
    clipped = (sx * sy > kmax) & (rad > 0)
    lim = float(2 ** 30)
    cx = torch.clamp(torch.clamp(mx / tile, -lim, lim).to(i32), 0, tiles_x - 1)
    cy = torch.clamp(torch.clamp(my / tile, -lim, lim).to(i32), 0, tiles_y - 1)
    sx_c = torch.clamp_max(sx, kmax)
    sy_c = torch.minimum(sy, torch.clamp_min(kmax // torch.clamp_min(sx_c, 1),
                                             1))
    sx_c = torch.minimum(sx_c,
                         torch.clamp_min(kmax // torch.clamp_min(sy_c, 1), 1))
    sx_c = torch.where(clipped, sx_c, sx)
    sy_c = torch.where(clipped, sy_c, sy)
    x0 = torch.where(clipped, torch.clamp(cx - sx_c // 2, x0,
                                          torch.maximum(x1 - sx_c, x0)), x0)
    y0 = torch.where(clipped, torch.clamp(cy - sy_c // 2, y0,
                                          torch.maximum(y1 - sy_c, y0)), y0)
    counts = torch.where(rad > 0, sx_c * sy_c, 0)
    return x0, y0, sx_c, counts, clipped


def _slot_tiles(mx, my, ca, cb, cc, op, x0, y0, sx_c, counts, tile: int,
                tiles_x: int, kmax: int, num_tiles: int):
    """[kmax, N] tile of each slot of the clipped rect (row-major), or
    `num_tiles` where the slot is empty or the ellipse cannot reach
    alpha 1/255 in that tile."""
    j = torch.arange(kmax, dtype=torch.int32, device=mx.device)[:, None]
    w = torch.clamp_min(sx_c, 1)[None, :]
    txs, tys = x0[None, :] + j % w, y0[None, :] + j // w
    u0 = (txs * tile).to(torch.float32) - mx[None, :]
    u1 = u0 + (tile - 1)
    v0 = (tys * tile).to(torch.float32) - my[None, :]
    v1 = v0 + (tile - 1)
    a, b, c = ca[None, :], cb[None, :], cc[None, :]
    r_vc = (-cb / torch.where(cc != 0.0, cc, 1.0))[None, :]
    r_uc = (-cb / torch.where(ca != 0.0, ca, 1.0))[None, :]

    def edge_u(u):
        vs = torch.clamp(r_vc * u, v0, v1)
        return a * u * u + 2.0 * b * u * vs + c * vs * vs

    def edge_v(v):
        us = torch.clamp(r_uc * v, u0, u1)
        return a * us * us + 2.0 * b * us * v + c * v * v

    inside = (u0 <= 0) & (0 <= u1) & (v0 <= 0) & (0 <= v1)
    qmin = torch.minimum(torch.minimum(edge_u(u0), edge_u(u1)),
                         torch.minimum(edge_v(v0), edge_v(v1)))
    qmin = torch.where(inside, 0.0, qmin)
    reach = (qmin * (1.0 - 1e-3)
             <= 2.0 * torch.log(255.0 * torch.clamp_min(op, 1e-12))[None, :])
    valid = (j < counts[None, :]) & reach
    return torch.where(valid, tys * tiles_x + txs, num_tiles).to(torch.int64)


def _parent_major(tile_of_slot, tiles_x: int, num_tiles: int):
    """A gaussian's slots reordered by 32 px parent tile, then the 2x2
    16 px tiles inside it (the 16 px configuration's slot rank)."""
    tx, ty = tile_of_slot % tiles_x, tile_of_slot // tiles_x
    pm = (((ty >> 1) * (tiles_x >> 1) + (tx >> 1)) * 4
          + (ty & 1) * 2 + (tx & 1))
    pm = torch.where(tile_of_slot < num_tiles, pm, num_tiles)
    order = torch.sort(pm, dim=0, stable=True).indices
    return torch.gather(tile_of_slot, 0, order)


def grid(width: int, height: int, tile: int):
    """(tiles_x, tiles_y): the 32 px grid, or at 16 px two tiles a 32 px
    parent in each direction."""
    px, py = -(-width // 32), -(-height // 32)
    return (px, py) if tile == 32 else (2 * px, 2 * py)


def bin_records(cols, colors: torch.Tensor, opacity: torch.Tensor,
                width: int, height: int, tile: int, kmax: int) -> Binned:
    """Records of every (tile, gaussian) pair in each tile's segment,
    front to back; at equal depth the lower slot rank, then the lower
    gaussian, first."""
    tiles_x, tiles_y = grid(width, height, tile)
    num_tiles = tiles_x * tiles_y
    mx, my, ca, cb, cc = (t.detach() for t in (cols.mx, cols.my, cols.ca,
                                              cols.cb, cols.cc))
    op = opacity.detach().to(torch.float32)
    rad = cols.radius.detach().to(torch.float32)
    x0, y0, sx_c, counts, clipped = _rects(mx, my, rad, tile, tiles_x,
                                           tiles_y, kmax)
    tos = _slot_tiles(mx, my, ca, cb, cc, op, x0, y0, sx_c, counts, tile,
                      tiles_x, kmax, num_tiles)
    if tile == 16:
        tos = _parent_major(tos, tiles_x, num_tiles)
    n = mx.shape[0]
    flat = tos.reshape(-1)
    slot = torch.nonzero(flat < num_tiles).squeeze(1)  # j * N + n, ascending
    gid = slot % max(n, 1)
    tile_of = flat[slot]
    order = torch.argsort(cols.depth.detach()[gid], stable=True)
    order = order[torch.argsort(tile_of[order], stable=True)]
    gid, tile_of = gid[order], tile_of[order]
    per_tile = torch.bincount(tile_of, minlength=num_tiles)
    end = torch.cumsum(per_tile, 0)
    rec = torch.stack([mx, my, ca, cb, cc, op, colors[:, 0].detach(),
                       colors[:, 1].detach(), colors[:, 2].detach()])
    return Binned(rec[:, gid].contiguous(), gid, end - per_tile, end,
                  tiles_x, tiles_y, tile, int(clipped.sum()))


def _pixels(b: Binned, width: int, height: int, dev):
    t_idx = torch.arange(b.tiles_x * b.tiles_y, device=dev)
    p_idx = torch.arange(b.tile * b.tile, device=dev)
    x = (t_idx % b.tiles_x)[:, None] * b.tile + (p_idx % b.tile)[None, :]
    y = (t_idx // b.tiles_x)[:, None] * b.tile + (p_idx // b.tile)[None, :]
    return x.to(torch.float32), y.to(torch.float32), (x < width) & (
        y < height)


def _untile(v: torch.Tensor, b: Binned) -> torch.Tensor:
    c, t = v.shape[0], b.tile
    return (v.reshape(c, b.tiles_y, b.tiles_x, t, t).permute(0, 1, 3, 2, 4)
            .reshape(c, b.tiles_y * t, b.tiles_x * t))


def _tile(v: torch.Tensor, b: Binned) -> torch.Tensor:
    c, t = v.shape[0], b.tile
    return (v.reshape(c, b.tiles_y, t, b.tiles_x, t).permute(0, 1, 3, 2, 4)
            .reshape(c, b.tiles_y * b.tiles_x, t * t))


def _alpha(rec, px, py):
    mx, my, ca, cb, cc, op = rec[0], rec[1], rec[2], rec[3], rec[4], rec[5]
    dx, dy = mx - px, my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    return dx, dy, power, torch.clamp_max(op * torch.exp(power), ALPHA_MAX)


class _Tiles:
    """The tiles ordered by their record count, longest first, so that
    the tiles that still have a record at step l are a prefix; `active(l)`
    is its length."""

    def __init__(self, b: Binned):
        count = b.tile_end - b.tile_start
        self.order = torch.argsort(count, descending=True, stable=True)
        self.start = b.tile_start[self.order]
        self.counts = count[self.order].tolist()
        self.steps = self.counts[0] if self.counts else 0
        self.n = len(self.counts)

    def active(self, step: int) -> int:
        while self.n and self.counts[self.n - 1] <= step:
            self.n -= 1
        return self.n

    def unsort(self, v: torch.Tensor) -> torch.Tensor:
        """[C, T, ...] in count order -> in tile order."""
        out = torch.empty_like(v)
        out[:, self.order] = v
        return out


def blend_fwd(b: Binned, width: int, height: int,
              work: Optional[Dict[str, int]] = None):
    """(rgb [3, Hp, Wp] without background, final T [Hp, Wp])."""
    dev = b.records.device
    t = _Tiles(b)
    px, py, live = (v[t.order] for v in _pixels(b, width, height, dev))
    nt, npx = b.tiles_x * b.tiles_y, b.tile * b.tile
    trans = torch.ones((nt, npx), device=dev)
    acc = torch.zeros((3, nt, npx), device=dev)
    tally = torch.zeros(3, dtype=torch.int64, device=dev)
    for step in range(t.steps):
        n = t.active(step)
        rec = b.records[:, t.start[:n] + step][:, :, None]
        _, _, power, alpha = _alpha(rec, px[:n], py[:n])
        todo = live[:n]
        ok = todo & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = trans[:n] * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        contrib = ok & ~stop
        w = torch.where(contrib, alpha * trans[:n], 0.0)
        acc[:, :n] = acc[:, :n] + rec[6:9] * w[None]
        trans[:n] = torch.where(contrib, test_t, trans[:n])
        live[:n] = todo & ~stop
        if work is not None:
            tally += torch.stack([todo.sum(), ok.sum(), contrib.sum()])
    if work is not None:
        evals, passed, contribs = (int(v) for v in tally.tolist())
        work.update(evals=evals, passed=passed, contribs=contribs,
                    pairs=int(b.records.shape[1]))
    return (_untile(t.unsort(acc), b),
            _untile(t.unsort(trans[None]), b)[0])


def blend_bwd(b: Binned, width: int, height: int, grad: torch.Tensor,
              rgb: torch.Tensor, t_fin: torch.Tensor, bg: torch.Tensor
              ) -> torch.Tensor:
    """Per-record gradients [9, P] (means, conic, opacity, colour) for the
    image cotangent `grad` [3, Hp, Wp]: each record's forward replayed,
    dL/dpower formed, the nine sums taken over the tile's pixels."""
    dev = b.records.device
    t = _Tiles(b)
    px, py, live = (v[t.order] for v in _pixels(b, width, height, dev))
    nt, npx = b.tiles_x * b.tiles_y, b.tile * b.tile
    g = _tile(grad, b)[:, t.order]
    acc = _tile(rgb, b)[:, t.order]
    tf = _tile(t_fin[None], b)[0][t.order]
    gtot = ((acc[0] * g[0] + acc[1] * g[1] + acc[2] * g[2])
            + (bg[0] * g[0] + bg[1] * g[1] + bg[2] * g[2]) * tf)
    trans = torch.ones((nt, npx), device=dev)
    prefix = torch.zeros((nt, npx), device=dev)
    out = torch.zeros_like(b.records)
    for step in range(t.steps):
        n = t.active(step)
        rows = t.start[:n] + step
        rec = b.records[:, rows][:, :, None]
        dx, dy, power, alpha = _alpha(rec, px[:n], py[:n])
        todo = live[:n]
        ok = todo & (power <= 0.0) & (alpha >= ALPHA_MIN)
        one_m = 1.0 - alpha
        test_t = trans[:n] * one_m
        stop = ok & (test_t < T_EPS)
        contrib = ok & ~stop
        w = torch.where(contrib, alpha * trans[:n], 0.0)
        gn = g[:, :n]
        gc = rec[6] * gn[0] + rec[7] * gn[1] + rec[8] * gn[2]
        pre = torch.where(contrib, prefix[:n] + gc * w, prefix[:n])
        prefix[:n] = pre
        d_alpha = torch.where(contrib, gc * trans[:n] - (gtot[:n] - pre)
                              / torch.clamp_min(one_m, 1.0 - ALPHA_MAX), 0.0)
        d_power = torch.where(alpha < ALPHA_MAX, d_alpha * alpha, 0.0)
        dpx, dpy = d_power * dx, d_power * dy
        s = torch.stack([d_power, dpx, dpy, dpx * dx, dpx * dy, dpy * dy,
                         gn[0] * w, gn[1] * w, gn[2] * w]).sum(dim=-1)
        ca, cb, cc, op = rec[2, :, 0], rec[3, :, 0], rec[4, :, 0], rec[5, :, 0]
        out[:, rows] = torch.stack([-(ca * s[1] + cb * s[2]),
                                    -(cb * s[1] + cc * s[2]),
                                    -0.5 * s[3], -s[4], -0.5 * s[5],
                                    s[0] / torch.clamp_min(op, OP_MIN),
                                    s[6], s[7], s[8]])
        trans[:n] = torch.where(contrib, test_t, trans[:n])
        live[:n] = todo & ~stop
    return out


class _Blend(torch.autograd.Function):
    """image = rgb + bg T, cropped, with gradients to the means, conics,
    colours, opacities and bg, summed per gaussian by index_add."""

    @staticmethod
    def forward(ctx, mx, my, ca, cb, cc, colors, opacity, bg, binned,
                width: int, height: int):
        rgb, t_fin = blend_fwd(binned, width, height)
        ctx.save_for_backward(rgb, t_fin, bg)
        ctx.binned, ctx.size, ctx.n = binned, (width, height), mx.shape[0]
        return (rgb + bg[:, None, None] * t_fin[None])[:, :height, :width]

    @staticmethod
    def backward(ctx, g_img):
        rgb, t_fin, bg = ctx.saved_tensors
        (width, height), b = ctx.size, ctx.binned
        gpad = torch.zeros_like(rgb)
        gpad[:, :height, :width] = g_img
        per_rec = blend_bwd(b, width, height, gpad, rgb, t_fin, bg.detach())
        per_g = per_rec.new_zeros((9, ctx.n)).index_add_(1, b.gauss_id,
                                                         per_rec)
        d_bg = (g_img * t_fin[None, :height, :width]).sum(dim=(1, 2))
        return (per_g[0], per_g[1], per_g[2], per_g[3], per_g[4],
                per_g[6:9].T.contiguous(), per_g[5], d_bg, None, None, None)


def rasterize(cols, colors, opacity, bg, width: int, height: int, tile: int,
              kmax: int):
    """(image [3, H, W], binned records)."""
    b = bin_records(cols, colors, opacity, width, height, tile, kmax)
    img = _Blend.apply(cols.mx, cols.my, cols.ca, cols.cb, cols.cc, colors,
                       opacity, bg, b, width, height)
    return img, b
