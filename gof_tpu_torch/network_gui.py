"""Interactive network viewer hook (counterpart of gof_tpu/network_gui.py).

Replaces gaussian_renderer/network_gui.py (the SIBR socket bridge, which the
reference fork itself keeps disabled, train.py:372-373). The protocol is
gof_tpu's length-prefixed JSON request -> raw RGB reply:

  request:  uint32 n, then n bytes of JSON
            {"width": W, "height": H, "fovx": f, "fovy": f,
             "world_view": [[...4x4...]], "scaling_modifier": 1.0}
  reply:    uint32 len, then W*H*3 uint8 RGB bytes

Run the listener with `serve(...)` from a training/eval process, or use
`try_connect/receive/send` in a loop exactly like the reference's hook.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Callable, Optional

import numpy as np

_listener: Optional[socket.socket] = None
_conn: Optional[socket.socket] = None


def init(host: str = "127.0.0.1", port: int = 6009) -> None:
    global _listener
    _listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    _listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    _listener.bind((host, port))
    _listener.listen()
    _listener.settimeout(0)


def try_connect() -> bool:
    global _conn
    if _listener is None:
        return False
    try:
        _conn, _ = _listener.accept()
        _conn.settimeout(None)
        return True
    except (BlockingIOError, socket.timeout):
        return False


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client disconnected")
        buf += chunk
    return buf


def receive() -> Optional[dict]:
    """Blocking read of one camera request; None on disconnect."""
    global _conn
    if _conn is None:
        return None
    try:
        (n,) = struct.unpack("<I", _read_exact(_conn, 4))
        return json.loads(_read_exact(_conn, n).decode())
    except (ConnectionError, struct.error):
        _conn = None
        return None


def send(image_chw: np.ndarray) -> None:
    global _conn
    if _conn is None:
        return
    rgb = (np.clip(np.asarray(image_chw), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    payload = rgb.tobytes()
    try:
        _conn.sendall(struct.pack("<I", len(payload)) + payload)
    except (BrokenPipeError, ConnectionError):
        _conn = None


def camera_from_request(req: dict, device=None):
    """Build the port's Camera from a viewer request (MiniCam analog), with
    gof_tpu's matrices, on `device`: the card unless a device is given."""
    import torch

    from . import cameras as cameras_lib
    from .transforms import projection_matrix

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU path")
        device = "cuda"

    w2v = np.asarray(req["world_view"], np.float32)
    proj = projection_matrix(0.01, 100.0, req["fovx"], req["fovy"])
    full = (proj @ w2v).astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return cameras_lib.Camera(
        width=int(req["width"]), height=int(req["height"]), world_view=f32(w2v),
        full_proj=f32(full), cam_center=f32(np.linalg.inv(w2v)[:3, 3]),
        tan_fovx=f32(np.tan(req["fovx"] / 2)), tan_fovy=f32(np.tan(req["fovy"] / 2)),
    )


def serve(render_fn: Callable, host: str = "127.0.0.1", port: int = 6009,
          device=None) -> None:
    """Blocking serve loop: render_fn(camera) -> [3+, H, W] image (a tensor
    on any device, or an array). Cameras are built on `device`, the card
    unless a device is given."""
    init(host, port)
    print(f"network_gui listening on {host}:{port}")
    import time

    while True:
        if _conn is None:
            if not try_connect():
                time.sleep(0.05)
                continue
        req = receive()
        if req is None:
            continue
        cam = camera_from_request(req, device)
        img = render_fn(cam)[:3]
        send(img.detach().cpu().numpy() if hasattr(img, "detach") else img)
