"""splatco_torch's losses, tri-plane regulariser and noise, LR schedules and
multi-group Adam against splatco_tpu's, on the CPU.

Inputs come from numpy with a seed and go to both sides.  Tolerances:
image metrics at 1e-6 (float32 sums over a few thousand pixels in another
order); the blur's VJP at 1e-6 absolute; schedules at rtol 1e-6 (the same
float32 log-lerp); one Adam update at rtol 1e-6 (the same float32 ops,
up to the bias correction's `pow`); the TV value at rtol 1e-5 (sums over
planes of thousands of texels) and its gradient at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_train_step import build_toy

from splatco_torch.config import OptimizationConfig
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.models.triplane import quantization_noise, tv_loss
from splatco_torch.ops import losses as t_losses
from splatco_torch.train import optimizer as t_opt
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig
from splatco_tpu.models import triplane as j_triplane
from splatco_tpu.ops import losses as j_losses
from splatco_tpu.train import optimizer as j_opt


def flat_numpy(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree, prefix=""):
    """{keystr path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, val in items:
        out.update(flat_torch(val, prefix + key))
    return out


def images(seed=0, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr",
                                  "psnr_scalar", "ssim"])
def test_image_metrics_match_jax(name):
    a, b = images()
    want = np.asarray(getattr(j_losses, name)(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = getattr(t_losses, name)(torch.as_tensor(a),
                                  torch.as_tensor(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_masked_ssim_and_batched_ssim_match_jax():
    a, b = images(1)
    mask = np.zeros(a.shape[1:], bool)
    mask[:30, :41] = True
    want = j_losses.masked_ssim(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(mask))
    got = t_losses.masked_ssim(torch.as_tensor(a), torch.as_tensor(b),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    want = j_losses.ssim(jnp.asarray(a[None]), jnp.asarray(b[None]),
                         size_average=False)
    got = t_losses.ssim(torch.as_tensor(a[None]), torch.as_tensor(b[None]),
                        size_average=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_blur_vjp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 24, 33)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    g1d = j_losses._gaussian_1d(11, 1.5)
    out, vjp = jax.vjp(lambda v: j_losses.sep_gauss_blur(v, jnp.asarray(g1d)),
                       jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    got = t_losses.sep_gauss_blur(xt, t_losses._gaussian_1d(11, 1.5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-6)
    (gx,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=1e-6)


def test_ssim_grad_matches_jax():
    a, b = images(3)
    want = jax.grad(lambda v: j_losses.ssim(v, jnp.asarray(b)))(
        jnp.asarray(a))
    at = torch.as_tensor(a).requires_grad_()
    (got,) = torch.autograd.grad(t_losses.ssim(at, torch.as_tensor(b)), at)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8,
                               rtol=1e-5)


@pytest.mark.parametrize("level", [0, 2])
def test_group_schedules_match_jax(level):
    opt = OptimizationConfig()
    want = j_opt.group_schedules(JOptimizationConfig(), 2.5, level)
    got = t_opt.group_schedules(opt, 2.5, level)
    assert sorted(got) == sorted(want)
    for step in (0, 1, 500, 29_999):
        for name, fn in want.items():
            w = float(fn(jnp.int32(step)))
            g = float(got[name](torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def toy():
    """The JAX toy model, its optax optimizer, and one update's state."""
    cfg, params, state, cams, gts = build_toy()
    tx = j_opt.make_optimizer(JOptimizationConfig(), params, 1.3, 0)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape) * 10.0 ** rng.uniform(-8, 0), jnp.float32),
        params) for _ in range(2)]
    s0 = tx.init(params)
    u1, s1 = tx.update(grads[0], s0, params)
    p1 = jax.tree.map(lambda p, u: p + u, params, u1)
    return params, tx, grads, s1, p1


def test_label_params_match_jax(toy):
    params = toy[0]
    want = flat_numpy(j_opt.label_params(params))
    got = flat_torch(t_opt.label_params(
        params_from_numpy(flat_numpy(params), device="cpu")))
    assert got == {k: str(v) for k, v in want.items()}


def test_opt_state_from_numpy_round_trips_optax_state(toy):
    _, _, _, s1, _ = toy
    flat = flat_numpy(s1)
    state = t_opt.opt_state_from_numpy(flat, device="cpu")
    seen = 0
    for key, arr in flat.items():
        group, part, field, path = t_opt._OPTAX_KEY.match(key).groups()
        if field == "count":
            got = state["count" if part == "0" else "sched_count"][group]
            assert got.dtype == torch.int32
        else:
            got = flat_torch(state[field])[path]
        np.testing.assert_array_equal(got.numpy(), arr, key)
        seen += 1
    n_leaves = len(flat_numpy(toy[0]))
    assert seen == len(flat) == 2 * n_leaves + 2 * len(state["count"])
    with pytest.raises(ValueError):
        t_opt.opt_state_from_numpy({"['anchors']['anchor']": arr},
                                   device="cpu")


def test_adam_update_matches_optax(toy):
    """Step 2 of the multi-group Adam from the same state and grads: new
    params and moments at rtol 1e-6, the counts exactly."""
    params, tx, grads, s1, p1 = toy
    u2, s2 = tx.update(grads[1], s1, p1)
    want = flat_numpy(jax.tree.map(lambda p, u: p + u, p1, u2))
    want_state = flat_numpy(s2)

    tp1 = params_from_numpy(flat_numpy(p1), device="cpu")
    ttx = t_opt.make_optimizer(OptimizationConfig(), tp1, 1.3, 0,
                               device="cpu")
    state = t_opt.opt_state_from_numpy(flat_numpy(s1), device="cpu")
    new, new_state = ttx.update(
        params_from_numpy(flat_numpy(grads[1]), device="cpu"), state, tp1)
    got = flat_torch(new)
    assert sorted(got) == sorted(want)
    moved = 0
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6,
                                   atol=1e-12, err_msg=key)
        moved += int(not np.array_equal(want[key], flat_numpy(p1)[key]))
    assert moved > 10
    got_state = t_opt.opt_state_from_numpy(want_state, device="cpu")
    for field in ("count", "sched_count"):
        assert {g: int(c) for g, c in new_state[field].items()} == \
            {g: int(c) for g, c in got_state[field].items()}
    for field in ("mu", "nu"):
        a, b = flat_torch(new_state[field]), flat_torch(got_state[field])
        for key in b:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                       rtol=1e-6, atol=1e-30, err_msg=key)
    # the inputs are not modified
    np.testing.assert_array_equal(flat_torch(tp1)["['anchors']['anchor']"],
                                  flat_numpy(p1)["['anchors']['anchor']"])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_tv_loss_and_grad_match_jax(level):
    rng = np.random.default_rng(level)
    grids = [{n: rng.normal(size=(3, s, s)).astype(np.float32) * 0.8
              for n in ("xy", "xz", "yz")} for s in (16, 16, 32)]
    jplanes = {"grids": jax.tree.map(jnp.asarray, grids)}
    want, jg = jax.value_and_grad(
        lambda p: j_triplane.tv_loss(p, 1.0, level))(jplanes)
    tgrids = [{n: torch.as_tensor(v).requires_grad_() for n, v in g.items()}
              for g in grids]
    got = tv_loss({"grids": tgrids}, 1.0, level)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    leaves = [tgrids[i][n] for i in range(level + 1)
              for n in ("xy", "xz", "yz")]
    tg = torch.autograd.grad(got, leaves)
    for (i, n), g in zip([(i, n) for i in range(level + 1)
                          for n in ("xy", "xz", "yz")], tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg["grids"][i][n]),
                                   rtol=1e-6, atol=1e-12)


def test_quantization_noise_range_and_reproducibility():
    q = 0.03
    feats = [torch.zeros(5000, 3), torch.zeros(5000, 3)]
    gen = torch.Generator().manual_seed(7)
    view0 = quantization_noise(feats, q, gen)
    view1 = quantization_noise(feats, q, gen)
    for v in view0 + view1:
        assert float(v.min()) >= -q / 2 and float(v.max()) < q / 2
        assert float(v.std()) == pytest.approx(q / 12 ** 0.5, rel=0.05)
    assert not torch.equal(view0[0], view1[0])   # each view its own draw
    assert not torch.equal(view0[0], view0[1])   # each plane its own draw
    again = quantization_noise(feats, q, torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(view0, again))
