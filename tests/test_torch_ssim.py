"""splatco_torch's SSIM (ops/losses.py) against splatco_tpu's on the CPU,
with the map's hand-written VJP (`_SSIMMap`) in place of autograd through
the formula, and the plain versions the card's kernels (csrc/sep_blur.cu,
csrc/ssim_map_fwd.cu, csrc/ssim_map_bwd.cu) repeat.

Inputs come from numpy with a seed and go to both sides.  Tolerances:
values at rtol 1e-6 / atol 1e-6 and gradients at atol 1e-8 / rtol 1e-5,
those of tests/test_torch_losses_optim.py (float32 sums over pixels
in another order; `jax.grad` and the hand VJP round the same arithmetic
in other orders).  The hand VJP against torch autograd through the old
formula, both in float64: 1e-12 of each moment's largest |gradient| (the
same terms, summed in another order).  The plain versions against numpy
float32 loops written as the kernels compute (a sliding vertical window,
then a horizontal pass over a zero-padded intermediate; the map's
arithmetic of csrc/ssim.cuh): bit for bit, NaN and inf included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.ops import losses as t_losses
from splatco_tpu.ops import losses as j_losses

# (B, C, H, W): the existing tests' size, H or W below the 11-tap window,
# odd sizes with B > 1, a 1x1 image
SHAPES = {"40x56": (1, 3, 40, 56), "h7": (1, 3, 7, 30), "w6": (1, 3, 25, 6),
          "odd_b2": (2, 3, 17, 23), "1x1": (1, 3, 1, 1)}
VALUE_RTOL = VALUE_ATOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-8, 1e-5


def image_pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    return a, b


def mask_of(shape, seed):
    rng = np.random.default_rng(seed + 100)
    return rng.uniform(size=shape[-2:]) < 0.7


def torch_value_and_grads(fn, a, b, ct=None):
    at = torch.as_tensor(a).requires_grad_()
    bt = torch.as_tensor(b).requires_grad_()
    out = fn(at, bt)
    ga, gb = torch.autograd.grad(
        out, (at, bt), torch.ones_like(out) if ct is None
        else torch.as_tensor(ct))
    return out.detach().numpy(), ga.numpy(), gb.numpy()


def jax_value_and_grads(fn, a, b, ct=None):
    out, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.ones_like(out) if ct is None else jnp.asarray(ct))
    return np.asarray(out), np.asarray(ga), np.asarray(gb)


def metric_fns(name, shape, seed):
    """The port's and JAX's function of the two images for `name`."""
    if name == "ssim_map":
        return t_losses._ssim_map, j_losses._ssim_map
    if name == "ssim":
        return t_losses.ssim, j_losses.ssim
    if name == "ssim_per_image":
        return (lambda x, y: t_losses.ssim(x, y, size_average=False),
                lambda x, y: j_losses.ssim(x, y, size_average=False))
    mask = mask_of(shape, seed)
    return (lambda x, y: t_losses.masked_ssim(x, y, torch.as_tensor(mask)),
            lambda x, y: j_losses.masked_ssim(x, y, jnp.asarray(mask)))


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("name", ["ssim_map", "ssim", "ssim_per_image",
                                  "masked_ssim"])
def test_ssim_and_its_gradients_match_jax(name, shape):
    a, b = image_pair(shape, 7)
    t_fn, j_fn = metric_fns(name, shape, 7)
    ct = None
    if name == "ssim_map":
        # a seeded cotangent for the whole map, at the scale `mean` sends
        # back (one over the map's size), where the tolerances hold
        ct = (np.random.default_rng(8).normal(size=shape)
              / np.prod(shape)).astype(np.float32)
    got = torch_value_and_grads(t_fn, a, b, ct)
    want = jax_value_and_grads(j_fn, a, b, ct)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_unequal_gate_crops_match_jax():
    """The consistency gate's SSIM of two views of unequal size, each
    cropped to the smaller height and width (non-contiguous views)."""
    rng = np.random.default_rng(9)
    gi = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    gj = rng.uniform(size=(3, 36, 60)).astype(np.float32)
    mh, mw = 36, 56
    got = t_losses.ssim(torch.as_tensor(gi)[..., :mh, :mw],
                        torch.as_tensor(gj)[..., :mh, :mw])
    want = j_losses.ssim(jnp.asarray(gi)[..., :mh, :mw],
                         jnp.asarray(gj)[..., :mh, :mw])
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)
    got = torch_value_and_grads(
        lambda x, y: t_losses.ssim(x[..., :mh, :mw], y[..., :mh, :mw]),
        gi, gj)
    want = jax_value_and_grads(
        lambda x, y: j_losses.ssim(x[..., :mh, :mw], y[..., :mh, :mw]),
        gi, gj)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def blurred_stack(shape, seed, dtype=torch.float32):
    a, b = (torch.as_tensor(x, dtype=dtype) for x in image_pair(shape, seed))
    stack = torch.cat([a, b, a * a, b * b, a * b])
    return t_losses._sep_gauss_blur(
        stack, t_losses._gaussian_1d(11, 1.5).astype(
            np.float64 if dtype == torch.float64 else np.float32))


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_hand_vjp_matches_autograd_in_float64(shape):
    stack = blurred_stack(shape, 3, torch.float64)
    g = torch.as_tensor(np.random.default_rng(4).normal(size=shape))
    leaf = stack.clone().requires_grad_()
    (want,) = torch.autograd.grad(t_losses._ssim_map_fwd_plain(leaf), leaf,
                                  g)
    got = t_losses._ssim_map_bwd_plain(g, stack)
    assert got.shape == stack.shape and got.dtype == torch.float64
    b = shape[0]
    for k in range(5):
        w = want[k * b:(k + 1) * b]
        scale = float(w.abs().max())
        assert float((got[k * b:(k + 1) * b] - w).abs().max()) <= \
            1e-12 * scale, k


def blur_numpy(x, taps):
    """The blur as csrc/sep_blur.cu computes it, in float32: a sliding
    vertical window (rows outside [0, H) read +0.0), then a horizontal
    pass over the intermediate padded with +0.0."""
    p, h, w = x.shape
    r = len(taps) // 2
    t = np.asarray(taps, np.float32)
    xp = np.zeros((p, h + 2 * r, w), np.float32)
    xp[:, r:r + h] = x
    v = t[0] * xp[:, 0:h]
    for i in range(1, len(t)):
        v = v + t[i] * xp[:, i:i + h]
    vp = np.zeros((p, h, w + 2 * r), np.float32)
    vp[:, :, r:r + w] = v
    out = t[0] * vp[:, :, 0:w]
    for i in range(1, len(t)):
        out = out + t[i] * vp[:, :, i:i + w]
    return out


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def nonfinite(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.copy()
    flat = x.reshape(-1)
    idx = np.random.default_rng(seed).choice(flat.size, size=min(
        3, flat.size), replace=False)
    flat[idx[:1]] = np.nan
    flat[idx[1:2]] = np.inf
    flat[idx[2:]] = -np.inf
    return x


@pytest.mark.parametrize("window", [1, 3, 11, 31])
@pytest.mark.parametrize("shape", [(5, 40, 56), (3, 7, 30), (2, 25, 6),
                                   (4, 17, 23), (1, 1, 1)])
@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan_inf"])
def test_plain_blur_is_the_kernels_arithmetic(shape, window, special):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    if special:
        x = nonfinite(x, 6)
    taps = t_losses._gaussian_1d(window, 1.5)
    got = t_losses.sep_gauss_blur(torch.as_tensor(x)[None], taps)[0]
    with np.errstate(invalid="ignore"):
        want = blur_numpy(x, taps)
    assert same_bits(got.numpy(), want)


def map_numpy(m, c1, c2):
    mu1, mu2, e11, e22, e12 = m
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    return ((np.float32(2) * mu1_mu2 + c1)
            * (np.float32(2) * (e12 - mu1_mu2) + c2)) / (
        ((mu1_sq + mu2_sq) + c1) * (((e11 - mu1_sq) + (e22 - mu2_sq)) + c2))


def map_vjp_numpy(m, g, c1, c2):
    """csrc/ssim.cuh's `map_vjp`, in float32."""
    two = np.float32(2)
    mu1, mu2, e11, e22, e12 = m
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    a = two * mu1_mu2 + c1
    b = two * (e12 - mu1_mu2) + c2
    d = (mu1_sq + mu2_sq) + c1
    e = ((e11 - mu1_sq) + (e22 - mu2_sq)) + c2
    den = d * e
    g_num = g / den
    g_den = -g * ((a * b) / den / den)
    g_b = g_num * a
    g_e = g_den * d
    g_mu1_mu2 = two * (g_num * b) - two * g_b
    g_sq = g_den * e - g_e
    return np.concatenate([two * mu1 * g_sq + mu2 * g_mu1_mu2,
                           two * mu2 * g_sq + mu1 * g_mu1_mu2, g_e, g_e,
                           two * g_b])


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan_inf"])
def test_plain_map_and_vjp_are_the_kernels_arithmetic(shape, special):
    stack = blurred_stack(shape, 11).numpy()
    if special:
        stack = nonfinite(stack, 12)
    g = np.random.default_rng(13).normal(size=shape).astype(np.float32)
    c1, c2 = np.float32(t_losses.C1), np.float32(t_losses.C2)
    b = shape[0]
    m = [stack[k * b:(k + 1) * b] for k in range(5)]
    with np.errstate(all="ignore"):
        want_map = map_numpy(m, c1, c2)
        want_vjp = map_vjp_numpy(m, g, c1, c2)
        want_mean = map_vjp_numpy(m, np.float32(0.25), c1, c2)
    st = torch.as_tensor(stack)
    assert same_bits(t_losses.ssim_map_fwd(st).numpy(), want_map)
    assert same_bits(t_losses.ssim_map_bwd(torch.as_tensor(g), st).numpy(),
                     want_vjp)
    # `mean`'s cotangent: one value at every pixel
    one = torch.full(shape, 0.25)
    assert same_bits(t_losses.ssim_map_bwd(one, st).numpy(), want_mean)


@pytest.mark.parametrize("fn", ["sep_blur", "ssim_map_fwd", "ssim_map_bwd"])
def test_wrappers_raise_on_an_unsupported_device(fn):
    x = torch.zeros((5, 3, 8, 9), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if fn == "sep_blur":
            t_losses.sep_blur(x, t_losses._gaussian_1d(11, 1.5))
        elif fn == "ssim_map_fwd":
            t_losses.ssim_map_fwd(x)
        else:
            t_losses.ssim_map_bwd(torch.zeros((1, 3, 8, 9), device="meta"),
                                  x)


@pytest.mark.parametrize("window", [33, 12])
def test_blur_raises_on_a_window_it_does_not_take(window):
    x = torch.zeros((1, 3, 40, 40))
    with pytest.raises(ValueError, match="odd window of at most 31"):
        t_losses.sep_blur(x, t_losses._gaussian_1d(window, 1.5))
    with pytest.raises(ValueError, match="odd window of at most 31"):
        t_losses.ssim(x, x, window_size=window)


def test_wrappers_raise_on_shapes_they_do_not_take():
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        t_losses.sep_blur(torch.zeros((3, 8, 9)),
                          t_losses._gaussian_1d(11, 1.5))
    with pytest.raises(ValueError, match="stack"):
        t_losses.ssim_map_fwd(torch.zeros((4, 3, 8, 9)))
    with pytest.raises(ValueError, match="cotangent"):
        t_losses.ssim_map_bwd(torch.zeros((2, 3, 8, 9)),
                              torch.zeros((5, 3, 8, 9)))


@pytest.mark.parametrize("name", ["ssim", "ssim_per_image", "masked_ssim",
                                  "training_loss"])
def test_the_map_gets_a_dense_cotangent(name, monkeypatch):
    """What every caller sends back to `_SSIMMap` is a dense [B, C, H, W]
    tensor (`mean`'s backward divides its expanded cotangent, a masked
    sum multiplies it), so the kernel's `contiguous()` copies nothing.
    `training_loss` is the training step's (1 - lam) L1 + lam (1 - SSIM)."""
    shape = (1, 3, 24, 30)
    a, b = image_pair(shape, 15)
    at, bt = torch.as_tensor(a).requires_grad_(), torch.as_tensor(b)
    fns = {"ssim": t_losses.ssim,
           "ssim_per_image": lambda x, y: t_losses.ssim(
               x, y, size_average=False).sum(),
           "masked_ssim": lambda x, y: t_losses.masked_ssim(
               x, y, torch.as_tensor(mask_of(shape, 15))),
           "training_loss": lambda x, y: 0.8 * t_losses.l1_loss(x, y)
           + 0.2 * (1.0 - t_losses.ssim(x, y))}
    seen = []
    bwd = t_losses.ssim_map_bwd

    def recording(g, stack):
        seen.append((g.shape, g.stride(), g.is_contiguous()))
        return bwd(g, stack)

    monkeypatch.setattr(t_losses, "ssim_map_bwd", recording)
    fns[name](at, bt).backward()
    assert seen == [(torch.Size(shape), (3 * 24 * 30, 24 * 30, 30, 1),
                     True)]


def test_profiled_ssim_records_its_range():
    """A profiled forward and backward of `ssim` records the "ssim" range
    three times: the forward, the map's backward, the blur's backward."""
    a, b = image_pair((3, 24, 30), 14)
    at = torch.as_tensor(a).requires_grad_()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss = 1.0 - t_losses.ssim(at, torch.as_tensor(b))
        loss.backward()
    names = [e.name for e in prof.events()]
    assert names.count("ssim") == 3
