"""The dense backend of splatco_torch: its compositor against splatco_tpu's
`rasterize_dense` and against the port's kernel path, and the dense
training step and render against the JAX package's, on the CPU.

Tolerances:
  * port vs JAX dense compositor: image and final_T 1e-5; gradients
    max-normalised 5e-4 against `jax.grad` (the rasterizer gradient bound
    of tests/test_torch_raster_bwd.py: the two take their cumulative
    products and matmul sums in other orders),
  * the port's kernel path (its plain versions here) vs its dense
    compositor on scenes where no tile rect clips: image 3e-7, gradients
    max-normalised 1.1e-6, the limits the JAX kernels were held to
    against this oracle,
  * the dense step against JAX's dense step: the limits
    tests/test_torch_train_step.py holds the kernel-path step to (loss
    and l1 1e-5 relative, the statistics' counts exactly, step-2 params
    max-normalised 1e-3); render within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses_optim import flat_numpy, flat_torch
from test_torch_raster import SCENES, both_cols
from test_torch_raster_bwd import cotangent, max_norm_err
from test_torch_train_step import TERMS, check_stats, port_inputs, toy_case

from splatco_torch.config import ModelConfig, OptimizationConfig
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.models.contraction import Contractor
from splatco_torch.models.renderer import render
from splatco_torch.models.splatco import decode_kwargs, params_from_numpy
from splatco_torch.ops import rasterize as t_ras
from splatco_torch.ops.rasterize_reference import rasterize_dense
from splatco_torch.train.optimizer import make_optimizer
from splatco_torch.train.step import make_train_step
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models.renderer import render as j_render
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs
from splatco_tpu.ops.rasterize_reference import \
    rasterize_dense as j_rasterize_dense
from splatco_tpu.train.optimizer import make_optimizer as j_make_optimizer
from splatco_tpu.train.step import init_stats as j_init_stats
from splatco_tpu.train.step import make_train_step as j_make_train_step
from splatco_tpu.config import OptimizationConfig as JOptimizationConfig

BG = np.asarray([0.2, 0.3, 0.4], np.float32)
NAMES = ("mx", "my", "ca", "cb", "cc", "colors", "opacities", "bg")
# the scenes where no gaussian's tile rect is clipped to kmax 12
UNCLIPPED = sorted(s for s in SCENES if s != "clipped")


def leaves(tcols, colors, opac):
    x = {"mx": tcols.mx, "my": tcols.my, "ca": tcols.ca, "cb": tcols.cb,
         "cc": tcols.cc, "colors": torch.as_tensor(np.array(colors)),
         "opacities": torch.as_tensor(np.array(opac)),
         "bg": torch.as_tensor(BG)}
    return {k: v.clone().requires_grad_() for k, v in x.items()}


def port_image_grads(fn, tcols, colors, opac, gimg):
    """(image, final_T or None, {leaf: grad}) of fn(cols, colors, opac, bg)
    under the cotangent gimg."""
    x = leaves(tcols, colors, opac)
    cols = tcols._replace(mx=x["mx"], my=x["my"], ca=x["ca"], cb=x["cb"],
                          cc=x["cc"])
    img, final_t = fn(cols, x["colors"], x["opacities"], x["bg"])
    (img * torch.as_tensor(gimg)).sum().backward()
    return (img.detach().numpy(),
            None if final_t is None else final_t.detach().numpy(),
            {k: v.grad.numpy() for k, v in x.items()})


@pytest.mark.parametrize("tile_size", [None, 32])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dense_matches_jax(scene, tile_size):
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    _, tcols = both_cols(proj)
    gimg = cotangent(h, w)

    want_img, want_t = j_rasterize_dense(proj, colors, opac,
                                         jnp.asarray(BG), h, w,
                                         tile_size=tile_size)

    def loss(means2d, conics, col, op, bgv):
        p = proj._replace(means2d=means2d, conics=conics)
        img, _ = j_rasterize_dense(p, col, op, bgv, h, w,
                                   tile_size=tile_size)
        return jnp.sum(img * gimg)

    gm, gc, gcol, gop, gbg = jax.grad(loss, argnums=tuple(range(5)))(
        proj.means2d, proj.conics, colors, opac, jnp.asarray(BG))
    want = {"mx": gm[:, 0], "my": gm[:, 1], "ca": gc[:, 0], "cb": gc[:, 1],
            "cc": gc[:, 2], "colors": gcol, "opacities": gop, "bg": gbg}

    img, final_t, got = port_image_grads(
        lambda c, col, op, bgv: rasterize_dense(c, col, op, bgv, h, w,
                                                tile_size=tile_size),
        tcols, colors, opac, gimg)
    np.testing.assert_allclose(img, np.asarray(want_img), atol=1e-5)
    np.testing.assert_allclose(final_t, np.asarray(want_t), atol=1e-5)
    for name in NAMES:
        err = max_norm_err(got[name], want[name])
        assert err < 5e-4, (name, err)


@pytest.mark.parametrize("scene", UNCLIPPED)
def test_kernel_path_matches_dense(scene):
    proj, colors, opac, cam = SCENES[scene]()
    h, w = cam.image_height, cam.image_width
    _, tcols = both_cols(proj)
    gimg = cotangent(h, w)
    dense_img, _, dense_g = port_image_grads(
        lambda c, col, op, bgv: rasterize_dense(c, col, op, bgv, h, w,
                                                tile_size=32),
        tcols, colors, opac, gimg)
    kern_img, _, kern_g = port_image_grads(
        lambda c, col, op, bgv: (t_ras.rasterize(c, col, op, bgv, h, w),
                                 None),
        tcols, colors, opac, gimg)
    np.testing.assert_allclose(kern_img, dense_img, atol=3e-7)
    for name in NAMES:
        err = max_norm_err(kern_g[name], dense_g[name])
        assert err < 1.1e-6, (name, err)


def test_kernel_path_reports_clipping_where_dense_does_not():
    """On the scene whose rects clip, the kernel path counts the clipped
    gaussians; the dense compositor never clips (its counter is 0)."""
    proj, colors, opac, cam = SCENES["clipped"]()
    _, tcols = both_cols(proj)
    args = (tcols, torch.as_tensor(np.array(colors)),
            torch.as_tensor(np.array(opac)), torch.as_tensor(BG),
            cam.image_height, cam.image_width)
    _, aux = t_ras.rasterize(*args, return_aux=True)
    assert int(aux["num_clipped"]) > 0


# ---------------------------------------------------------------------
# the dense training step and render


def jax_dense_steps(case, n_steps):
    cfg, params, state, cam_args, gts = case
    cams = tuple(j_look_at(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h, uid=i)
                 for i, (eye, fx, fy, w, h) in enumerate(cam_args))
    tx = j_make_optimizer(JOptimizationConfig(), params, 1.0, 0)
    step = j_make_train_step(cfg, JOptimizationConfig(), mv=2,
                             activate_level=0, tx=tx, backend="dense",
                             q_noise=0.0)
    carry = (params, tx.init(params),
             j_init_stats(params["anchors"]["anchor"].shape[0],
                          cfg.n_offsets))
    out = [carry]
    for it in range(n_steps):
        res = step(*carry[:2], state.active, state.contractor, carry[2],
                   cams, gts, jnp.zeros(3), jax.random.key(it),
                   jnp.int32(it), jnp.float32(TERMS["consistency_on"]),
                   jnp.float32(TERMS["tv_w"]),
                   jnp.float32(TERMS["stats_on"]))
        out.append(jax.tree.map(np.asarray, res))
        carry = res[:3]
    return out


def port_dense_step(case, params, opt_state, stats):
    """The port's dense step (q = 0) on the arguments port_inputs builds
    for its kernel-path step."""
    _, args = port_inputs(case, params, opt_state, stats)
    jcfg = case[0]
    cfg = ModelConfig(**{k: getattr(jcfg, k)
                         for k in ModelConfig.__dataclass_fields__})
    tx = make_optimizer(OptimizationConfig(), args[0], 1.0, 0, device="cpu")
    step = make_train_step(cfg, OptimizationConfig(), 2, 0, tx, q_noise=0.0,
                           device="cpu", backend="dense")
    return step(*args)


@pytest.fixture(scope="module")
def dense_runs():
    case = toy_case()
    jx = jax_dense_steps(case, 2)
    return {"case": case, "jax": jx,
            "port1": port_dense_step(case, *jx[0]),
            "port2": port_dense_step(case, *jx[1][:3])}


@pytest.mark.parametrize("step", [1, 2])
def test_dense_step_matches_jax(dense_runs, step):
    got, want = dense_runs[f"port{step}"], dense_runs["jax"][step]
    for name in ("loss", "l1"):
        np.testing.assert_allclose(float(got[3][name]), float(want[3][name]),
                                   rtol=1e-5, err_msg=name)
    # the dense backend clips nothing and reports kmax as max_slots
    assert int(got[3]["num_clipped"]) == 0
    assert int(got[3]["max_slots"]) == int(want[3]["max_slots"])
    check_stats(got[2], want[2])


def test_dense_step2_params_match_jax(dense_runs):
    got = flat_torch(dense_runs["port2"][0])
    want = flat_numpy(dense_runs["jax"][2][0])
    before = flat_numpy(dense_runs["jax"][1][0])
    moved = 0
    for key in want:
        g = got[key].numpy().astype(np.float64)
        w = want[key].astype(np.float64)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-12)
        assert err < 1e-3, (key, err)
        moved += int(not np.array_equal(w, before[key]))
    assert moved > 10


def test_dense_render_matches_jax():
    cfg, params, state, cam_args, _ = toy_case()
    eye, fx, fy, w, h = cam_args[1]
    jcam = j_look_at(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    want = j_render(params, state.active, state.contractor, jcam,
                    jnp.asarray(bg), activate_level=0, backend="dense",
                    kmax=cfg.kmax, **j_decode_kwargs(cfg))
    tparams = params_from_numpy(flat_numpy(params), device="cpu")
    contractor = Contractor(
        xyz_min=torch.as_tensor(np.array(state.contractor.xyz_min)),
        xyz_max=torch.as_tensor(np.array(state.contractor.xyz_max)),
        enabled=state.contractor.enabled)
    cam = look_at_camera(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h,
                         device="cpu")
    with torch.no_grad():
        got = render(tparams, torch.as_tensor(np.array(state.active)),
                     contractor, cam, torch.as_tensor(bg),
                     activate_level=0, backend="dense", kmax=cfg.kmax,
                     **decode_kwargs(cfg))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               atol=1e-5)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert int(got.num_clipped) == 0 and got.num_overflow == 0
    assert int(got.max_slots) == cfg.kmax


def test_render_rejects_an_unknown_backend():
    cfg, params, state, cam_args, _ = toy_case()
    eye, fx, fy, w, h = cam_args[0]
    cam = look_at_camera(eye, [0, 0, 0], [0, -1, 0], fx, fy, w, h,
                         device="cpu")
    tparams = params_from_numpy(flat_numpy(params), device="cpu")
    with pytest.raises(ValueError):
        render(tparams, torch.as_tensor(np.array(state.active)), None, cam,
               torch.zeros(3), backend="pallas")
