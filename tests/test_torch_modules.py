"""splatco_torch modules against their splatco_tpu counterparts, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters are carried into the port through `params_from_numpy` after
flattening with `tree_flatten_with_path`.  Tolerances: where both sides do
the same elementwise float32 arithmetic the results are compared exactly
or to 1e-6; where a reduction or matmul is involved (MLPs, TPA means, the
3-NN statistics) the summation order differs between XLA and PyTorch, so
the bound is 1e-5 relative / 1e-5 absolute, a few float32 ulps of the
sums; BN output divides by sqrt(E[x^2] - mean^2), which magnifies those
ulps, so BN and the fusion heads after it are held to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatco_torch.data import cameras as t_cam
from splatco_torch.models import anchors as t_anchors
from splatco_torch.models import contraction as t_con
from splatco_torch.models import decoders as t_dec
from splatco_torch.models import mlp as t_mlp
from splatco_torch.models import triplane as t_tri
from splatco_torch.models.splatco import params_from_numpy
from splatco_torch.ops import knn as t_knn
from splatco_torch.ops import projection as t_proj
from splatco_tpu.data import cameras as j_cam
from splatco_tpu.models import anchors as j_anchors
from splatco_tpu.models import contraction as j_con
from splatco_tpu.models import decoders as j_dec
from splatco_tpu.models import mlp as j_mlp
from splatco_tpu.models import triplane as j_tri
from splatco_tpu.ops import knn as j_knn
from splatco_tpu.ops import projection as j_proj

RTOL = ATOL = 1e-5  # reductions in another order: a few f32 ulps


def to_torch(tree):
    """A JAX pytree -> the port's nested tensors, via keystr paths."""
    flat = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return params_from_numpy(flat, device="cpu")


def t(a):
    return torch.as_tensor(np.array(a))


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


CAMERAS = [
    ([0, 0, -3.0], [0, 0, 0], [0, -1, 0], 1.0, 0.75, 64, 48),
    ([2.5, 0.4, -1.0], [0.1, 0, 0.2], [0, -1, 0], 1.2, 0.9, 96, 64),
    ([-1.0, -2.0, 2.0], [0, 0, 0], [0, 0, 1], 0.8, 0.6, 40, 30),
]


@pytest.mark.parametrize("cam_args", CAMERAS)
def test_camera_matrices_and_centre(cam_args):
    """Both build the matrices in numpy float64 and cast: equal exactly."""
    jc = j_cam.look_at_camera(*cam_args)
    tc = t_cam.look_at_camera(*cam_args, device="cpu")
    for name in ("world_view_transform", "full_proj_transform",
                 "camera_center", "R", "T"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy(), name)
    assert (tc.tan_fovx, tc.tan_fovy) == (jc.tan_fovx, jc.tan_fovy)


@pytest.mark.parametrize("enabled", [True, False])
def test_contract(enabled):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3)).astype(np.float32) * 1.5
    jc = j_con.make_contractor([0.1, -0.2, 0.3], [2.0, 1.0, 3.0], 0.8,
                               enabled=enabled)
    tc = t_con.make_contractor([0.1, -0.2, 0.3], [2.0, 1.0, 3.0], 0.8,
                               enabled=enabled, device="cpu")
    close(j_con.contract(jc, jnp.asarray(xyz)), t_con.contract(tc, t(xyz)),
          rtol=1e-6, atol=1e-6)


def test_masked_batchnorm_partial_mask():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(300, 24)) * 2.0 + 0.5).astype(np.float32)
    mask = rng.uniform(size=300) < 0.6
    # padded rows carry junk that the statistics must ignore
    x[~mask] = 1e3
    bn = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
          "bias": rng.normal(size=24).astype(np.float32)}
    want = j_mlp.masked_batchnorm({k: jnp.asarray(v) for k, v in bn.items()},
                                  jnp.asarray(x), jnp.asarray(mask))
    got = t_mlp.masked_batchnorm({k: t(v) for k, v in bn.items()}, t(x),
                                 t(mask))
    close(np.asarray(want)[mask], got.numpy()[mask], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("appearance_dim,feat_bank", [(0, False), (8, True)])
def test_decoders(appearance_dim, feat_bank):
    feat_dim, k = 16, 4
    jp = j_dec.init_decoders(jax.random.key(3), feat_dim, k,
                             appearance_dim=appearance_dim,
                             use_feat_bank=feat_bank, num_cameras=5)
    tp = to_torch(jp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, feat_dim + 3 + j_dec.GEO_DIM)
                   ).astype(np.float32)
    close(j_dec.opacity_mlp(jp, jnp.asarray(x)), t_dec.opacity_mlp(tp, t(x)))
    close(j_dec.cov_mlp(jp, jnp.asarray(x)), t_dec.cov_mlp(tp, t(x)))
    xc = rng.normal(size=(200, feat_dim + 3 + appearance_dim
                          + j_dec.GEO_DIM)).astype(np.float32)
    close(j_dec.color_mlp(jp, jnp.asarray(xc)), t_dec.color_mlp(tp, t(xc)))
    if feat_bank:
        xb = rng.normal(size=(50, 4)).astype(np.float32)
        close(j_dec.feature_bank_mlp(jp, jnp.asarray(xb)),
              t_dec.feature_bank_mlp(tp, t(xb)))
    if appearance_dim:
        for uid in (-1, 2, 9):  # clipped to the table like the JAX side
            np.testing.assert_array_equal(
                np.asarray(j_dec.appearance_embedding(jp, uid, 7)),
                t_dec.appearance_embedding(tp, uid, 7).numpy())


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1.6, 1.6)],
                         ids=["in_range", "out_of_range"])
def test_sample_plane(lo, hi):
    """Bilinear, align_corners, zeros outside, u on the H axis (H != W so
    a swapped axis shows)."""
    rng = np.random.default_rng(4)
    plane = rng.normal(size=(3, 13, 9)).astype(np.float32)
    u = rng.uniform(lo, hi, 400).astype(np.float32)
    v = rng.uniform(lo, hi, 400).astype(np.float32)
    # exact corners and edges too
    u[:4], v[:4] = [-1, 1, -1, 1], [-1, -1, 1, 1]
    want = j_tri._sample_plane(jnp.asarray(plane), jnp.asarray(u),
                               jnp.asarray(v))
    got = t_tri._sample_plane(t(plane), t(u), t(v))
    assert got.shape == (400, 3)
    close(want, got, rtol=1e-6, atol=1e-6)
    if hi > 1:
        assert (got.abs().sum(1) == 0).any()  # some fall fully outside


def test_apply_tpa():
    rng = np.random.default_rng(5)
    params = j_tri.init_tpa(jax.random.key(6), 9)
    x = rng.normal(size=(9, 20, 17)).astype(np.float32)
    want = j_tri.apply_tpa(params, jnp.asarray(x))
    got = t_tri.apply_tpa(to_torch(params), t(x))
    close(want, got)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_feature_planes_forward(level):
    """Levels >= 1 start with zero heads; give them random weights so
    every level's contribution is compared."""
    rng = np.random.default_rng(7)
    planes = j_tri.init_feature_planes(jax.random.key(8), 48, 9,
                                       ctx_dim=37)
    for i in (1, 2):
        for head in (planes["heads"][i], planes["ctx_heads"][i]):
            head["lin"]["w"] = jnp.asarray(
                rng.normal(size=head["lin"]["w"].shape) * 0.2, jnp.float32)
            head["lin"]["b"] = jnp.asarray(
                rng.normal(size=head["lin"]["b"].shape) * 0.2, jnp.float32)
    n = 256
    xyz = rng.uniform(-1.9, 1.9, size=(n, 3)).astype(np.float32)
    g_fea = rng.normal(size=(n, 37)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    want = j_tri.feature_planes_forward(planes, jnp.asarray(xyz),
                                        jnp.asarray(g_fea),
                                        jnp.asarray(mask),
                                        activate_level=level)
    got = t_tri.feature_planes_forward(to_torch(planes), t(xyz), t(g_fea),
                                       t(mask), activate_level=level)
    assert got.shape == (n, 64)
    close(np.asarray(want)[mask], got.numpy()[mask], rtol=1e-4, atol=1e-4)


def test_level_sizes():
    for quirk in (True, False):
        assert t_tri.level_sizes(2800, quirk_duplicate_level0=quirk) == \
            j_tri.level_sizes(2800, quirk_duplicate_level0=quirk)
    assert t_tri.level_sizes(2800) == [700, 700, 1400]


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    scales = (0.01 + 0.1 * rng.uniform(size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return means, scales, quats


@pytest.mark.parametrize("cam_args", CAMERAS[:2])
def test_project_gaussians_cols(cam_args):
    means, scales, quats = _gaussians(2000, 9)
    jc = j_cam.look_at_camera(*cam_args)
    tc = t_cam.look_at_camera(*cam_args, device="cpu")
    want = j_proj.project_gaussians_cols(jnp.asarray(means),
                                         jnp.asarray(scales),
                                         jnp.asarray(quats), jc)
    got = t_proj.project_gaussians_cols(t(means), t(scales), t(quats), tc)
    vis = np.asarray(want.radius) > 0
    assert vis.sum() > 100
    np.testing.assert_array_equal(np.asarray(want.radius), got.radius)
    for name in ("mx", "my", "depth", "ca", "cb", "cc"):
        close(np.asarray(getattr(want, name))[vis],
              getattr(got, name).numpy()[vis], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(j_proj.visible_filter(jnp.asarray(means),
                                         jnp.asarray(scales),
                                         jnp.asarray(quats), jc)),
        t_proj.visible_filter(t(means), t(scales), t(quats), tc).numpy())


def test_mean_knn_sq_dist():
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    want = j_knn.mean_knn_sq_dist(jnp.asarray(pts))
    got = t_knn.mean_knn_sq_dist(t(pts))
    close(want, got, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("voxel_size,capacity", [(0.05, 0), (0.0, 2048)])
def test_init_anchor_state(voxel_size, capacity):
    """Padding to the capacity, the active mask and every field; voxel
    size 0 resolves to the median 3-NN distance."""
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(1500, 3)).astype(np.float32) * 0.5
    js, jvox = j_anchors.init_anchor_state(pts, 16, 4, voxel_size,
                                           capacity=capacity)
    anchors, active, tvox = t_anchors.init_anchor_state(
        pts, 16, 4, voxel_size, capacity=capacity, device="cpu")
    assert tvox == pytest.approx(jvox, rel=1e-6)
    np.testing.assert_array_equal(np.asarray(js.active), active.numpy())
    for name in ("anchor", "feat", "offsets", "scaling", "rotation",
                 "opacity"):
        assert anchors[name].shape == getattr(js, name).shape, name
        close(getattr(js, name), anchors[name], rtol=1e-5, atol=1e-6)
