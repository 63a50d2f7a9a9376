"""The port's SIBR network viewer (viewer/network_gui.py) and the
trainer's viewer hook, on the CPU over localhost sockets.

The wire protocol (4-byte LE length + JSON in; RGB bytes + a
length-prefixed verify string out) and the control fields (`train`,
`scaling_modifier`, `keep_alive`) against a live server, as
tests/test_viewer.py holds the JAX server; the served bytes of a small
JAX-initialised model against uint8 of JAX's render with the same
scale_modifier (the dense oracle against the port's binned plain blend:
images within 3e-5, so bytes at most 1 apart, nearly all equal); the
Trainer held at its gate while a client pauses it and kept alive past
its last iteration; and the published snapshot, which never pairs the
params of one capacity with the mask of another across a regrowth.
"""
import json
import logging
import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import CAM, jax_model, port_cfg, port_model

from splatco_torch.config import (ModelConfig, OptimizationConfig,
                                  PipelineConfig)
from splatco_torch.data.cameras import look_at_camera
from splatco_torch.data.scene import Scene
from splatco_torch.train.loop import Trainer, ViewerSnapshot
from splatco_torch.utils.synthetic import write_blender_dataset
from splatco_torch.viewer.network_gui import (ViewerServer,
                                              camera_from_message)
from splatco_tpu.data.cameras import look_at_camera as j_look_at
from splatco_tpu.models import renderer as j_renderer
from splatco_tpu.models.splatco import decode_kwargs as j_decode_kwargs

SOURCE = "stub_scene"
TIMEOUT = 60


class StubTrainer:
    """What the server reads of a trainer: a published snapshot of a
    small JAX-initialised model carried into the port."""

    def __init__(self):
        self.jcfg, self.jparams, self.jstate = jax_model()
        self.cfg = port_cfg(self.jcfg)
        self.cfg.source_path = SOURCE
        params, active, contractor = port_model(self.jparams, self.jstate)
        self.backend, self.dev = "cuda", torch.device("cpu")
        self.bg = np.array([0.1, 0.2, 0.3], np.float32)
        self.published = ViewerSnapshot(0, params, active, contractor, 0,
                                        self.cfg.kmax, torch.tensor(self.bg))


def message(cam_args=CAM, train=True, keep_alive=False,
            scaling_modifier=1.0, resolution=None):
    """A SIBR message for look_at_camera(*cam_args), with the viewer's
    sign flips the server undoes."""
    cam = look_at_camera(*cam_args, device="cpu")
    view = cam.world_view_transform.numpy().copy()
    proj = cam.full_proj_transform.numpy().copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj[:, 1] *= -1
    w, h = resolution or (cam.image_width, cam.image_height)
    return {
        "resolution_x": w, "resolution_y": h, "train": train,
        "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
        "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist(),
    }


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def roundtrip(sock, msg):
    raw = json.dumps(msg).encode("utf-8")
    sock.sendall(len(raw).to_bytes(4, "little") + raw)
    img = None
    if msg["resolution_x"] and msg["resolution_y"]:
        img = recv_exact(sock, msg["resolution_x"] * msg["resolution_y"]
                         * 3)
    n = int.from_bytes(recv_exact(sock, 4), "little")
    return img, recv_exact(sock, n).decode("ascii")


def connect(server):
    sock = socket.create_connection(("127.0.0.1", server.port), TIMEOUT)
    sock.settimeout(TIMEOUT)
    return sock


def wait_for(cond, what, timeout=TIMEOUT):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.02)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    srv = ViewerServer(StubTrainer(), host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()
    assert not srv._thread.is_alive()


def test_camera_from_message_is_the_sent_camera():
    cam = look_at_camera(*CAM, device="cpu")
    got = camera_from_message(message(), device="cpu")
    for f in ("world_view_transform", "full_proj_transform",
              "camera_center"):
        assert torch.equal(getattr(got, f), getattr(cam, f)), f
    assert (got.fovx, got.fovy, got.image_width, got.image_height) == (
        cam.fovx, cam.fovy, cam.image_width, cam.image_height)
    assert camera_from_message(message(resolution=(0, 48))) is None


def test_protocol_roundtrip(server):
    with connect(server) as sock:
        img, verify = roundtrip(sock, message())
        assert verify == SOURCE
        arr = np.frombuffer(img, np.uint8).reshape(48, 64, 3)
        assert arr.std() > 0
        img2, verify2 = roundtrip(sock, message(resolution=(0, 0)))
        assert img2 is None and verify2 == SOURCE
    assert server.error is None


def test_train_gate_scaling_modifier_and_keep_alive(server):
    with connect(server) as sock:
        roundtrip(sock, message(train=False, scaling_modifier=0.5))
        assert server.scaling_modifier == 0.5
        assert server.keep_alive is False
        released = threading.Event()
        gate = threading.Thread(
            target=lambda: (server.wait_training_allowed(), released.set()),
            daemon=True)
        gate.start()
        wait_for(lambda: server.trainer_waiting, "the gate")
        time.sleep(0.3)
        assert not released.is_set(), "the gate must hold while paused"
        roundtrip(sock, message(train=True, keep_alive=True))
        gate.join(TIMEOUT)
        assert released.is_set() and not gate.is_alive()
        assert server.keep_alive is True and not server.trainer_waiting
    # a disconnect releases a paused trainer too
    with connect(server) as sock:
        roundtrip(sock, message(train=False, resolution=(0, 0)))
    gate = threading.Thread(target=server.wait_training_allowed,
                            daemon=True)
    gate.start()
    gate.join(TIMEOUT)
    assert not gate.is_alive()


def test_served_bytes_match_jax_render(server):
    """The frame served at scaling_modifier 0.5 against JAX's render of
    the same params with scale_modifier=0.5, in bytes."""
    tr = server.trainer
    with connect(server) as sock:
        half, _ = roundtrip(sock, message(scaling_modifier=0.5))
        full, _ = roundtrip(sock, message(scaling_modifier=1.0))
    jcam = j_look_at(*CAM)
    vis = j_renderer.prefilter_voxel(tr.jparams["anchors"],
                                     tr.jstate.active, jcam)
    out = j_renderer.render(
        tr.jparams, tr.jstate.active, tr.jstate.contractor, jcam,
        jnp.asarray(tr.bg), visible_mask=vis, activate_level=0,
        is_training=False, backend="dense", scale_modifier=0.5,
        **j_decode_kwargs(tr.jcfg))
    want = (np.asarray(jnp.clip(out.image, 0.0, 1.0)).transpose(1, 2, 0)
            * 255).astype(np.uint8)
    got = np.frombuffer(half, np.uint8).reshape(want.shape)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-2
    assert half != full


# ----------------------------------------------------------------------
# the trainer's hook
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viewer_blender"))
    write_blender_dataset(path, n_views=6, n_pts=150, width=64, height=48,
                          device="cpu")
    return path


def make_trainer(dataset):
    cfg = ModelConfig(source_path=dataset, feat_dim=8, n_offsets=4,
                      voxel_size=0.05, plane_size=32, num_channels=9,
                      appearance_dim=0, contractor=True, eval=True)
    opt = OptimizationConfig(update_from=2, update_interval=3,
                             update_until=22, start_stat=1)
    scene = Scene(cfg, shuffle=False, write_artifacts=False, device="cpu")
    tr = Trainer(cfg, opt, PipelineConfig(mv=2), device="cpu",
                 logger=logging.getLogger("test_torch_viewer"),
                 test_iterations=(), save_iterations=(),
                 checkpoint_iterations=())
    tr.setup(scene, seed=1)
    return tr


def test_trainer_waits_while_paused_and_serves_past_its_end(dataset):
    tr = make_trainer(dataset)
    tr.viewer = ViewerServer(tr, port=0)
    tr.viewer.start()
    try:
        cam = (CAM[0], CAM[1], CAM[2], CAM[3], CAM[4], 32, 24)
        with connect(tr.viewer) as sock:
            roundtrip(sock, message(cam, train=False))
            run = threading.Thread(target=tr.train,
                                   kwargs={"iterations": 3}, daemon=True)
            run.start()
            wait_for(lambda: tr.viewer.trainer_waiting, "the gate")
            time.sleep(0.5)
            assert tr.published.iteration == 0 and run.is_alive()
            # while paused, a frame is the published snapshot's
            img, _ = roundtrip(sock, message(cam, train=False))
            assert len(img) == 32 * 24 * 3
            roundtrip(sock, message(cam, train=True, keep_alive=True))
            wait_for(lambda: tr.viewer.finished, "the last iteration")
            assert tr.published.iteration == 3
            time.sleep(0.3)
            assert run.is_alive(), "keep_alive must hold the trainer"
            img, _ = roundtrip(sock, message(cam, keep_alive=True))
            assert len(img) == 32 * 24 * 3
        run.join(TIMEOUT)
        assert not run.is_alive()
        assert tr.viewer.error is None
    finally:
        tr.viewer.stop()


def test_snapshot_never_mixes_capacities(dataset):
    """A reader on another thread renders the published snapshot while
    the trainer regrows its capacity three times: every snapshot pairs
    params and mask of one capacity, and a regrowth shows only once
    published."""
    tr = make_trainer(dataset)
    tr.viewer = ViewerServer(tr, port=0)
    tr.viewer.start()
    cam = look_at_camera(*CAM[:5], 32, 24, device="cpu")
    seen, errors = set(), []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            snap = tr.published
            c = snap.params["anchors"]["anchor"].shape[0]
            if snap.active.shape[0] != c or any(
                    a.shape[0] != c for a in snap.params["anchors"].values()):
                errors.append(c)
            seen.add(c)
            tr.viewer.render_frame(cam, 1.0)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=reader, daemon=True)
    try:
        thread.start()
        c0 = tr.params["anchors"]["anchor"].shape[0]
        wait_for(lambda: c0 in seen, "the reader")
        for n in (2, 4, 8):
            before = tr.published
            tr._grow(c0 * n)
            # the trainer's own attributes changed, the snapshot did not
            assert tr.published is before
            time.sleep(0.05)
            tr.publish()
            wait_for(lambda: c0 * n in seen, "the reader")
    finally:
        stop.set()
        thread.join(TIMEOUT)
        sys.setswitchinterval(switch)
        tr.viewer.stop()
    assert not thread.is_alive()
    assert not errors
    assert seen == {c0, 2 * c0, 4 * c0, 8 * c0}
