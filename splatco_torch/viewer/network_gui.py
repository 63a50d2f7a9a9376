"""SIBR network viewer server (counterpart of
splatco_tpu/viewer/network_gui.py), with the reference's TCP wire
protocol: a 4-byte little-endian length and a JSON camera message in;
the raw RGB bytes of the frame (none for a zero resolution), then a
length-prefixed verify string (the scene's source path), out.

The server runs on its own thread.  It renders only the snapshot the
trainer publishes once an iteration (`Trainer.publish`: params, active
mask, contractor, level, kmax, bg, iteration), never the trainer's
attributes, which the trainer reassigns one by one (densify, regrowth,
kmax escalation, a level bump).  It renders on the default stream, so a
served frame runs between two steps' kernels, under `torch.no_grad()`
(grad mode is per thread), through the trainer's backend: the blend
kernel on a card.
"""
from __future__ import annotations

import json
import socket
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from splatco_torch.data.cameras import Camera
from splatco_torch.models.renderer import prefilter_voxel, render
from splatco_torch.models.splatco import decode_kwargs


def camera_from_message(msg: dict, device=None) -> Optional[Camera]:
    """The viewer's camera on `device`, or None for a zero resolution."""
    width = msg["resolution_x"]
    height = msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    proj[:, 1] = -proj[:, 1]
    cam_center = np.linalg.inv(view)[3, :3]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return Camera(
        world_view_transform=t(view), full_proj_transform=t(proj),
        camera_center=t(cam_center), image=None,
        R=t(np.eye(3)), T=t(np.zeros(3)),
        image_height=height, image_width=width,
        fovx=float(msg["fov_x"]), fovy=float(msg["fov_y"]), uid=0,
        znear=float(msg["z_near"]), zfar=float(msg["z_far"]))


class ViewerServer:
    """Serves SIBR viewer clients with the reference's control semantics
    (its train.py:150-161): the client's `train` field pauses and resumes
    training, `scaling_modifier` scales the rendered gaussians, and
    `keep_alive` keeps the server, and the trainer, alive past the last
    iteration.  The trainer calls `wait_training_allowed()` at the top of
    each iteration and `wait_released()` after the last one.

    `port` 0 binds an ephemeral port; `start()` binds before it returns,
    so `port` then holds the bound one.  `trainer_waiting` is true while
    the trainer is held at the gate, `finished` once its last iteration
    is done; `error` keeps the traceback of a frame that failed."""

    def __init__(self, trainer, host: str = "127.0.0.1", port: int = 6009):
        self.trainer = trainer
        self.host = host
        self.port = port
        self._stop = threading.Event()
        self._train_allowed = threading.Event()
        self._train_allowed.set()
        self._connected = False
        self._conn: Optional[socket.socket] = None
        self.keep_alive = False
        self.scaling_modifier = 1.0
        self.trainer_waiting = False
        self.finished = False
        self.error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen()
        listener.settimeout(0.5)
        self.port = listener.getsockname()[1]
        if self.trainer.published is None:
            self.trainer.publish()
        print(f"viewer listening on {self.host}:{self.port}")
        self._thread = threading.Thread(target=self._serve, args=(listener,),
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        """Close the listener and the connection, release the trainer."""
        self._stop.set()
        self._train_allowed.set()
        conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # ends a blocked recv
            except OSError:
                pass  # already closed
        if self._thread is not None:
            self._thread.join(timeout)

    def wait_training_allowed(self, poll: float = 0.05):
        """Block while a connected viewer has training paused."""
        self.trainer_waiting = True
        try:
            while self._connected and not self._train_allowed.is_set():
                if self._stop.is_set():
                    return
                self._train_allowed.wait(poll)
        finally:
            self.trainer_waiting = False

    def wait_released(self, poll: float = 0.2):
        """After the last iteration: serve on while a connected viewer
        asks to keep alive."""
        self.finished = True
        while (self._connected and self.keep_alive
               and not self._stop.is_set()):
            time.sleep(poll)

    # ------------------------------------------------------------------
    def _serve(self, listener):
        with listener:
            while not self._stop.is_set():
                try:
                    conn, addr = listener.accept()
                except socket.timeout:
                    continue
                print(f"\nviewer connected from {addr}")
                conn.settimeout(None)
                self._conn = conn
                self._connected = True
                try:
                    with conn:
                        self._handle(conn)
                except (ConnectionError, OSError):
                    pass  # the viewer closed its socket
                except Exception:
                    self.error = traceback.format_exc()
                    traceback.print_exc()
                finally:
                    self._conn = None
                    self._connected = False
                    self._train_allowed.set()

    @staticmethod
    def _recv_exact(conn, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def _read_message(self, conn) -> dict:
        n = int.from_bytes(self._recv_exact(conn, 4), "little")
        return json.loads(self._recv_exact(conn, n).decode("utf-8"))

    def render_frame(self, cam: Camera, scaling_modifier: float) -> bytes:
        """The published snapshot rendered from `cam`, as RGB bytes."""
        tr = self.trainer
        snap = tr.published
        with torch.no_grad():
            vis = prefilter_voxel(snap.params["anchors"], snap.active, cam)
            out = render(
                snap.params, snap.active, snap.contractor, cam, snap.bg,
                visible_mask=vis, activate_level=snap.activate_level,
                is_training=False, kmax=snap.kmax, backend=tr.backend,
                scale_modifier=scaling_modifier, **decode_kwargs(tr.cfg))
            # truncated to uint8 as numpy's astype truncates
            img = (torch.clamp(out.image, 0.0, 1.0).permute(1, 2, 0)
                   * 255).to(torch.uint8)
            return img.cpu().numpy().tobytes()

    def _handle(self, conn):
        tr = self.trainer
        while not self._stop.is_set():
            msg = self._read_message(conn)
            # the control fields (the reference's network_gui.receive)
            if bool(msg.get("train", True)):
                self._train_allowed.set()
            else:
                self._train_allowed.clear()
            self.keep_alive = bool(msg.get("keep_alive", False))
            self.scaling_modifier = float(msg.get("scaling_modifier", 1.0))
            cam = camera_from_message(msg, device=tr.dev)
            if cam is not None:
                conn.sendall(self.render_frame(cam, self.scaling_modifier))
            verify = tr.cfg.source_path.encode("ascii")
            conn.sendall(len(verify).to_bytes(4, "little"))
            conn.sendall(verify)
