"""Offline mesh viewer (python -m gof_tpu_torch.mesh_viewer <mesh.ply>;
counterpart of gof_tpu/mesh_viewer.py).

Replaces mesh_viewer.py (an Open3D window; no GUI/Open3D here): renders a
Lambert-shaded turntable of the mesh to PNG frames with a small numpy
z-buffer rasterizer, so meshes can be inspected headlessly.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_frame(verts, faces, eye, target, size=800, fov=0.9, light=(0.4, 0.6, 0.8)):
    up = np.array([0.0, 1.0, 0.0])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0, 0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    pv = (verts - eye) @ R.T
    f = size / (2 * np.tan(fov / 2))
    z = np.maximum(pv[:, 2], 1e-6)
    px = pv[:, 0] / z * f + size / 2
    py = pv[:, 1] / z * f + size / 2

    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    nn = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    lam = np.abs(nn @ (np.asarray(light) / np.linalg.norm(light)))
    shade = 0.25 + 0.7 * lam

    img = np.zeros((size, size), np.float32)
    zbuf = np.full((size, size), np.inf, np.float32)
    tp = np.stack([px[faces], py[faces]], axis=-1)  # [F, 3, 2]
    tz = z[faces].mean(axis=1)
    order = np.argsort(-tz)  # far to near (painter fallback with zbuffer)
    for fi in order:
        pts = tp[fi]
        x0, y0 = np.floor(pts.min(axis=0)).astype(int)
        x1, y1 = np.ceil(pts.max(axis=0)).astype(int)
        if x1 < 0 or y1 < 0 or x0 >= size or y0 >= size:
            continue
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        if (x1 - x0) * (y1 - y0) > 40_000:
            continue  # skip absurdly large screen triangles
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        a, b, c = pts
        d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(d) < 1e-9:
            continue
        w0 = ((b[1] - c[1]) * (xs - c[0]) + (c[0] - b[0]) * (ys - c[1])) / d
        w1 = ((c[1] - a[1]) * (xs - c[0]) + (a[0] - c[0]) * (ys - c[1])) / d
        w2 = 1 - w0 - w1
        m = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not m.any():
            continue
        zf = tz[fi]
        sel = m & (zf < zbuf[ys, xs])
        img[ys[sel], xs[sel]] = shade[fi]
        zbuf[ys[sel], xs[sel]] = zf
    return img


def main(argv=None):
    from PIL import Image

    from .utils import ply

    ap = argparse.ArgumentParser()
    ap.add_argument("mesh")
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ns = ap.parse_args(argv)

    verts_d, faces = ply.read_ply(ns.mesh)
    verts = np.stack([verts_d["x"], verts_d["y"], verts_d["z"]], -1).astype(np.float64)
    center = verts.mean(axis=0)
    radius = np.linalg.norm(verts - center, axis=1).max()
    out_dir = ns.out_dir or os.path.join(os.path.dirname(ns.mesh), "turntable")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(ns.frames):
        th = 2 * np.pi * i / ns.frames
        eye = center + np.array([2.5 * radius * np.sin(th), 0.8 * radius,
                                 2.5 * radius * np.cos(th)])
        img = render_frame(verts, faces, eye, center, size=ns.size)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"frame_{i:03d}.png")
        )
    print(f"{ns.frames} frames -> {out_dir}")


if __name__ == "__main__":
    main()
