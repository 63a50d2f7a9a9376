"""RAFT optical flow (counterpart of splatco_tpu/eval/raft.py): the learned
flow estimator of the popping harness (Teed & Deng, ECCV 2020; original
code BSD-3, princeton-vl/RAFT).

Parameters live in a flat dict keyed by the torch state-dict names (minus
the DataParallel "module." prefix), so the official checkpoints
(raft-things.pth and the like) load through `load_raft_weights`, and the
JAX package's parameters carry across through `raft_params_from_numpy`.

The "basic" model: hidden = context = 128, 4 correlation levels, radius 4.
  fnet   - BasicEncoder (output 256, instance norm): a 7x7/2 stem, three
           stages of two residual blocks (64, 96/2, 128/2), a 1x1 head;
           1/8 resolution
  cnet   - the same encoder with batch norm (eval: running statistics),
           output 256 split into tanh(hidden 128) and relu(context 128)
  corr   - all-pairs <f1, f2>/sqrt(256) pyramid (4 average-pooled
           levels), looked up in a (2r+1)^2 window around the current
           flow target
  update - BasicMotionEncoder + SepConvGRU + FlowHead, and a 64*9-channel
           convex-upsampling mask scaled by 0.25
iterated `iters` times from zero flow; the last 1/8-resolution flow is
convex-upsampled 8x.  Every convolution pads k//2 on each side, as torch's
Conv2d(padding=k//2) does.  On the card they must run in full float32:
`utils/device.resolve_device` turns cuDNN's TF32 off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splatco_torch.utils.device import resolve_device

HDIM = 128  # the hidden state's width; the context's is the same
CORR_LEVELS = 4
CORR_RADIUS = 4

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# primitives (NCHW)
# ----------------------------------------------------------------------

def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1):
    """Conv2d with padding k//2 on each side (every RAFT conv uses it)."""
    w = p[f"{name}.weight"]
    kh, kw = w.shape[2], w.shape[3]
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride=stride,
                    padding=(kh // 2, kw // 2))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per sample and channel over HW, with
    the biased variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps)


def batch_norm(p: Params, name: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in eval mode (running statistics)."""
    def col(s):
        return p[f"{name}.{s}"][None, :, None, None]

    return ((x - col("running_mean")) / torch.sqrt(col("running_var") + eps)
            * col("weight") + col("bias"))


def _norm(p, prefix, name, x, norm_fn):
    if norm_fn == "instance":
        return instance_norm(x)
    if norm_fn == "batch":
        return batch_norm(p, f"{prefix}.{name}", x)
    return x


# ----------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------

def residual_block(p, prefix, x, stride, norm_fn):
    y = F.relu(_norm(p, prefix, "norm1",
                     conv2d(p, f"{prefix}.conv1", x, stride=stride),
                     norm_fn))
    y = F.relu(_norm(p, prefix, "norm2", conv2d(p, f"{prefix}.conv2", y),
                     norm_fn))
    if stride != 1:
        x = _norm(p, prefix, "norm3",
                  conv2d(p, f"{prefix}.downsample.0", x, stride=stride),
                  norm_fn)
    return F.relu(x + y)


def basic_encoder(p: Params, prefix: str, x: torch.Tensor,
                  norm_fn: str) -> torch.Tensor:
    """BasicEncoder: [N,3,H,W] -> [N,256,H/8,W/8]."""
    x = conv2d(p, f"{prefix}.conv1", x, stride=2)
    x = F.relu(_norm(p, prefix, "norm1", x, norm_fn))
    for li, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        x = residual_block(p, f"{prefix}.{li}.0", x, stride, norm_fn)
        x = residual_block(p, f"{prefix}.{li}.1", x, 1, norm_fn)
    return conv2d(p, f"{prefix}.conv2", x)


# ----------------------------------------------------------------------
# correlation pyramid
# ----------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """All-pairs correlation: [h*w, 1, h/2^i, w/2^i] for each level i.
    Level 0 holds (h*w)^2 floats (2.96 GB at 1600x1088)."""
    n, d, h, w = fmap1.shape
    if n != 1:
        raise ValueError("the popping harness flows one frame pair at a "
                         "time")
    f1 = fmap1.reshape(d, h * w)
    f2 = fmap2.reshape(d, h * w)
    corr = torch.matmul(f1.t(), f2).div_(math.sqrt(d))
    corr = corr.reshape(h * w, 1, h, w)
    pyr = [corr]
    for _ in range(CORR_LEVELS - 1):
        corr = F.avg_pool2d(corr, 2)
        pyr.append(corr)
    return pyr


def _window_offsets(device) -> tuple:
    """The (2r+1)^2 window's x and y offsets in the reference's channel
    order.  The reference stacks its delta as meshgrid(dy, dx) but adds
    it to (x, y) centroids: the first meshgrid axis offsets x and the
    second y.  The window is square, so the set of taps is the natural
    one, but their channel order is its transpose; trained update weights
    are keyed to that order."""
    r = CORR_RADIUS
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    first, second = torch.meshgrid(d, d, indexing="ij")
    return first.reshape(-1), second.reshape(-1)


def lookup_corr(pyr, coords: torch.Tensor) -> torch.Tensor:
    """Sample each level bilinearly (zeros outside, the taps of
    grid_sample with align_corners=True) in the window around
    coords / 2^i.  coords: [2, h, w] pixel coordinates into level 0;
    returns [1, levels*(2r+1)^2, h, w]."""
    _, h1, w1 = coords.shape
    hw = h1 * w1
    dgx, dgy = _window_offsets(coords.device)
    out = []
    for i, corr in enumerate(pyr):
        _, _, h2, w2 = corr.shape
        cf = corr.reshape(hw, h2 * w2)
        cx = coords[0].reshape(hw, 1) / (2 ** i) + dgx[None, :]  # [HW,81]
        cy = coords[1].reshape(hw, 1) / (2 ** i) + dgy[None, :]
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        fx = cx - x0
        fy = cy - y0

        def tap(xi, yi, wgt):
            inb = (xi >= 0) & (xi <= w2 - 1) & (yi >= 0) & (yi <= h2 - 1)
            xi_c = torch.clamp(xi, 0, w2 - 1).long()
            yi_c = torch.clamp(yi, 0, h2 - 1).long()
            v = torch.gather(cf, 1, yi_c * w2 + xi_c)
            return torch.where(inb, v, 0.0) * wgt

        out.append(tap(x0, y0, (1 - fx) * (1 - fy))
                   + tap(x0 + 1, y0, fx * (1 - fy))
                   + tap(x0, y0 + 1, (1 - fx) * fy)
                   + tap(x0 + 1, y0 + 1, fx * fy))
    feat = torch.cat(out, dim=1)                          # [HW, 4*81]
    return feat.reshape(h1, w1, -1).permute(2, 0, 1)[None]


# ----------------------------------------------------------------------
# update block
# ----------------------------------------------------------------------

def motion_encoder(p, corr, flow):
    pre = "update_block.encoder"
    cor = F.relu(conv2d(p, f"{pre}.convc1", corr))
    cor = F.relu(conv2d(p, f"{pre}.convc2", cor))
    flo = F.relu(conv2d(p, f"{pre}.convf1", flow))
    flo = F.relu(conv2d(p, f"{pre}.convf2", flo))
    out = F.relu(conv2d(p, f"{pre}.conv", torch.cat([cor, flo], dim=1)))
    return torch.cat([out, flow], dim=1)  # 128 channels


def sep_conv_gru(p, h, x):
    pre = "update_block.gru"

    def half(h, tag):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv2d(p, f"{pre}.convz{tag}", hx))
        r = torch.sigmoid(conv2d(p, f"{pre}.convr{tag}", hx))
        q = torch.tanh(conv2d(p, f"{pre}.convq{tag}",
                              torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    return half(half(h, 1), 2)


def update_block(p, net, inp, corr, flow):
    mot = motion_encoder(p, corr, flow)
    net = sep_conv_gru(p, net, torch.cat([inp, mot], dim=1))
    fh = F.relu(conv2d(p, "update_block.flow_head.conv1", net))
    delta = conv2d(p, "update_block.flow_head.conv2", fh)
    m = F.relu(conv2d(p, "update_block.mask.0", net))
    mask = 0.25 * conv2d(p, "update_block.mask.2", m)
    return net, mask, delta


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: [N,2,h,w] flow, [N,576,h,w] mask ->
    [N,2,8h,8w]."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    fp = F.pad(8.0 * flow, (1, 1, 1, 1))
    # 3x3 neighbourhoods in unfold's order (row-major window)
    taps = torch.stack([fp[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)],
                       dim=2)                          # [N,2,9,h,w]
    up = torch.sum(mask * taps[:, :, :, None, None], dim=2)  # [N,2,8,8,h,w]
    up = up.permute(0, 1, 4, 2, 5, 3)                  # [N,2,h,8,w,8]
    return up.reshape(n, 2, 8 * h, 8 * w)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

def _timed_algorithms():
    """cuDNN choosing each convolution's algorithm by timing the candidates
    (benchmark mode; float32, deterministic algorithms) for the length of
    a `with`.  Its heuristics pick FFT and per-pixel GEMV algorithms for
    the update block's float32 convolutions on the H100: 3.8-4.8 s a
    flow at 1600x1088 against 0.23 s timed (PERF.md).  The choice is
    cached per shape for the process; timing the candidates once takes
    a workspace of up to ~28 GB at that size."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                      deterministic=True, allow_tf32=False)


def raft_flow(params: Params, image1: torch.Tensor, image2: torch.Tensor,
              iters: int = 20) -> torch.Tensor:
    """Flow image1 -> image2: images [1,3,H,W] in [0,255] with H, W
    multiples of 8 and at least 64 (four pooled correlation levels);
    returns [1,2,H,W] pixel flow."""
    with _timed_algorithms():
        return _raft_flow(params, image1, image2, iters)


def _raft_flow(params, image1, image2, iters):
    image1 = 2.0 * (image1 / 255.0) - 1.0
    image2 = 2.0 * (image2 / 255.0) - 1.0

    fmap1 = basic_encoder(params, "fnet", image1, "instance")
    fmap2 = basic_encoder(params, "fnet", image2, "instance")
    pyr = build_corr_pyramid(fmap1, fmap2)

    cnet = basic_encoder(params, "cnet", image1, "batch")
    net = torch.tanh(cnet[:, :HDIM])
    inp = F.relu(cnet[:, HDIM:])

    _, _, h, w = fmap1.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=image1.device),
        torch.arange(w, dtype=torch.float32, device=image1.device),
        indexing="ij")
    coords0 = torch.stack([gx, gy])           # [2,h,w]
    coords1 = coords0
    mask = None
    for _ in range(iters):
        corr = lookup_corr(pyr, coords1)
        flow = (coords1 - coords0)[None]
        net, mask, delta = update_block(params, net, inp, corr, flow)
        coords1 = coords1 + delta[0]
    if mask is None:
        return torch.zeros((1, 2, 8 * h, 8 * w), device=image1.device)
    return upsample_flow((coords1 - coords0)[None], mask)


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def raft_params_from_numpy(arrays: Mapping[str, np.ndarray],
                           device=None) -> Params:
    """Parameters from numpy arrays under the state-dict names (the JAX
    package's, through np.asarray) as float32 tensors on `device` (None:
    the card)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in arrays.items()}


def load_raft_weights(path: str, device=None) -> Params:
    """An official RAFT checkpoint (raft-things.pth and the like) on
    `device` (None: the card): the "module." prefix stripped and the
    batch-norm counters dropped."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        params[k] = v.float().to(dev)
    return params


def save_raft_weights(params: Params, path: str) -> None:
    """Write `params` as the official checkpoints are laid out: every key
    under "module.", and a num_batches_tracked counter beside each batch
    norm's running statistics."""
    sd = {}
    for k, v in params.items():
        sd[f"module.{k}"] = v.detach().cpu()
        if k.endswith(".running_var"):
            stem = k[:-len("running_var")]
            sd[f"module.{stem}num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)


def init_raft_params(generator: Optional[torch.Generator] = None,
                     device=None) -> Params:
    """Random parameters in the checkpoints' layout on `device` (None: the
    card), drawn from `generator` (a CPU generator) name by name in sorted
    order: the JAX init's scales, not its stream.  Real flow needs trained
    weights."""
    dev = resolve_device(device)
    shapes = {}

    def conv(name, o, i, kh, kw):
        shapes[f"{name}.weight"] = (o, i, kh, kw)
        shapes[f"{name}.bias"] = (o,)

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{s}"] = (c,)

    for pre, norm in (("fnet", "instance"), ("cnet", "batch")):
        conv(f"{pre}.conv1", 64, 3, 7, 7)
        if norm == "batch":
            bn(f"{pre}.norm1", 64)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for li, (cin, cout, stride) in enumerate(dims, start=1):
            for bi, (ci, st) in enumerate(((cin, stride), (cout, 1))):
                b = f"{pre}.layer{li}.{bi}"
                conv(f"{b}.conv1", cout, ci, 3, 3)
                conv(f"{b}.conv2", cout, cout, 3, 3)
                if norm == "batch":
                    bn(f"{b}.norm1", cout)
                    bn(f"{b}.norm2", cout)
                if st != 1:
                    conv(f"{b}.downsample.0", cout, ci, 1, 1)
                    if norm == "batch":
                        bn(f"{b}.norm3", cout)
        conv(f"{pre}.conv2", 256, 128, 1, 1)

    cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
    conv("update_block.encoder.convc1", 256, cor_planes, 1, 1)
    conv("update_block.encoder.convc2", 192, 256, 3, 3)
    conv("update_block.encoder.convf1", 128, 2, 7, 7)
    conv("update_block.encoder.convf2", 64, 128, 3, 3)
    conv("update_block.encoder.conv", 126, 256, 3, 3)
    for tag, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for g in ("z", "r", "q"):
            conv(f"update_block.gru.conv{g}{tag}", 128, 128 + 256, kh, kw)
    conv("update_block.flow_head.conv1", 256, 128, 3, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv("update_block.mask.0", 256, 128, 3, 3)
    conv("update_block.mask.2", 64 * 9, 256, 1, 1)

    params = {}
    for name, shp in sorted(shapes.items()):
        if name.endswith("running_var") or (name.endswith("weight")
                                            and len(shp) == 1):
            params[name] = torch.ones(shp)
        elif name.endswith(("bias", "running_mean")):
            params[name] = torch.zeros(shp)
        else:
            fan = int(np.prod(shp[1:]))
            params[name] = (torch.randn(shp, generator=generator)
                            * (math.sqrt(2.0 / max(fan, 1)) * 0.5))
    return {k: v.to(dev) for k, v in params.items()}


def make_flow_fn(params: Params, iters: int = 20,
                 device=None) -> Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]:
    """`raft_flow` as the popping harness's flow(a, b) -> [H,W,2] on
    `device` (None: the card): frames [H,W,3] in [0,1], zero-padded to
    multiples of 8."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}

    def prep(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        h, w = x.shape[:2]
        img = torch.zeros((1, 3, hp, wp), dtype=torch.float32, device=dev)
        img[0, :, :h, :w] = x.to(dev, torch.float32).permute(2, 0, 1)
        return img * 255.0

    def flow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h, w = a.shape[:2]
        hp = -(-h // 8) * 8
        wp = -(-w // 8) * 8
        with torch.inference_mode():
            out = raft_flow(params, prep(a, hp, wp), prep(b, hp, wp),
                            iters=iters)
        return out[0].permute(1, 2, 0)[:h, :w]

    return flow
