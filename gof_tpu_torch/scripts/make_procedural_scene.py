"""Full-resolution procedural multi-view scene (python -m
gof_tpu_torch.scripts.make_procedural_scene --out <dir>; counterpart of
scripts/make_procedural_scene.py, writing the same files byte for byte).

A textured ground plane + spheres + boxes shaded with view-independent
lambertian light and high-frequency 3D textures, ray-traced in numpy. Every
pixel is a pure function of the 3D hit point, so the views are exactly
multi-view consistent and the texture detail forces densification to work.

Writes a Blender-format scene dir (transforms_{train,test}.json + RGBA
PNGs + points3d.ply + gt_mesh.ply, the analytic surface) at any
resolution, default 1237x822 (the -r4 Mip-NeRF 360 "bicycle" size). The
views are traced by a pool of threads, one view each (numpy's array
operations and PIL's encoder release the interpreter lock); the seeds and
the files are the original script's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SPHERES = [  # center, radius, material id
    (np.array([0.0, -0.2, 0.0]), 0.8, 2),
    (np.array([1.6, -0.5, -0.9]), 0.5, 3),
    (np.array([-1.5, -0.45, 0.8]), 0.55, 4),
    (np.array([0.6, -0.7, 1.5]), 0.3, 5),
]
BOXES = [  # lo, hi, material id
    (np.array([-2.6, -1.0, -1.8]), np.array([-1.8, 0.1, -1.0]), 6),
    (np.array([1.1, -1.0, 0.4]), np.array([1.7, -0.3, 1.0]), 7),
]
PLANE_Y = -1.0
LIGHT = np.array([0.45, 0.8, 0.35]) / np.linalg.norm([0.45, 0.8, 0.35])

# --specular: Blinn-Phong lobe strength multiplier (0 = lambertian, the
# round-3 scene). View-DEPENDENT shading exercises SH degrees 1-3, which a
# lambertian scene barely trains. Per-material gloss:
_GLOSS = {1: (0.12, 48.0), 2: (0.7, 64.0), 3: (0.6, 96.0), 4: (0.8, 32.0),
          5: (0.5, 128.0), 6: (0.3, 24.0), 7: (0.45, 48.0)}


# Texture difficulty knobs (--tex-freq / --octaves): multiplying the base
# frequencies and adding octaves raises the image-gradient floor, which
# sustains densification much longer.
TEX_FREQ = 1.0
OCTAVES = 3


def _fbm(p, f0, seed, tex_freq=TEX_FREQ, octaves=OCTAVES):
    """Cheap band-limited 3D value noise from summed sines."""
    f0 = f0 * tex_freq
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    v = np.zeros_like(x)
    rng = np.random.default_rng(seed)
    for octave in range(octaves):
        f = f0 * (2.0**octave)
        a, b, c = rng.uniform(0, 2 * np.pi, 3)
        d = rng.uniform(-1, 1, (3, 3))
        v += (np.sin(f * (x * d[0, 0] + y * d[0, 1] + z * d[0, 2]) + a)
              * np.sin(f * (x * d[1, 0] + y * d[1, 1] + z * d[1, 2]) + b)
              + 0.5 * np.sin(f * (x * d[2, 0] + y * d[2, 1] + z * d[2, 2]) + c)
              ) / (2.0**octave)
    # keeps the historical amplitude (/3.0) at octaves=3 for any octave count
    return v / (3.0 * (2.0 - 2.0 ** (1 - octaves)) / 1.75)


def albedo(p, mat, tex_freq=TEX_FREQ, octaves=OCTAVES):
    """Procedural per-material albedo from the 3D point."""
    out = np.zeros(p.shape[:-1] + (3,), np.float32)
    x, z = p[..., 0], p[..., 2]
    # 0: sky (unused), 1: plane checker + noise
    m = mat == 1
    if m.any():
        check = ((np.floor(x * 2) + np.floor(z * 2)) % 2)
        base = np.where(check > 0.5, 0.62, 0.25)
        n = _fbm(p, 5.0, 11, tex_freq, octaves) * 0.18
        g = np.clip(base + n, 0, 1)
        out[m] = np.stack([g * 0.9, g, g * 0.75], axis=-1)[m]
    specs = {
        2: (np.array([0.75, 0.28, 0.22]), 9.0, 21),   # marble-red sphere
        3: (np.array([0.22, 0.45, 0.78]), 13.0, 22),  # blue
        4: (np.array([0.85, 0.72, 0.25]), 7.0, 23),   # gold stripes
        5: (np.array([0.5, 0.8, 0.45]), 16.0, 24),    # green fine detail
        6: (np.array([0.6, 0.4, 0.65]), 8.0, 25),     # purple box
        7: (np.array([0.3, 0.65, 0.6]), 12.0, 26),    # teal box
    }
    for k, (base, freq, seed) in specs.items():
        m = mat == k
        if m.any():
            n = _fbm(p, freq, seed, tex_freq, octaves)[..., None] * 0.28
            out[m] = np.clip(base[None] + n, 0.02, 0.98)[m]
    return out


def trace(origin, dirs):
    """Nearest-hit ray trace. dirs: [..., 3] normalized. Returns t, mat."""
    sh = dirs.shape[:-1]
    t = np.full(sh, np.inf, np.float32)
    mat = np.zeros(sh, np.int32)
    # plane y = PLANE_Y
    dy = dirs[..., 1]
    tp = np.where(np.abs(dy) > 1e-7, (PLANE_Y - origin[1]) / dy, np.inf)
    hitp = (tp > 1e-3) & (tp < t)
    # bound the plane so the scene is finite
    px = origin[0] + tp * dirs[..., 0]
    pz = origin[2] + tp * dirs[..., 2]
    hitp &= (np.abs(px) < 7.0) & (np.abs(pz) < 7.0)
    t = np.where(hitp, tp, t)
    mat = np.where(hitp, 1, mat)
    for c, r, mid in SPHERES:
        oc = origin - c
        b = np.einsum("...i,i->...", dirs, oc)
        disc = b * b - (oc @ oc - r * r)
        ok = disc > 0
        ts = -b - np.sqrt(np.where(ok, disc, 0))
        hit = ok & (ts > 1e-3) & (ts < t)
        t = np.where(hit, ts, t)
        mat = np.where(hit, mid, mat)
    for lo, hi, mid in BOXES:
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
        t0 = (lo - origin) * inv
        t1 = (hi - origin) * inv
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        hit = (tmax > tmin) & (tmin > 1e-3) & (tmin < t)
        t = np.where(hit, tmin, t)
        mat = np.where(hit, mid, mat)
    return t, mat


def normal_at(p, mat, origin):
    n = np.zeros_like(p)
    n[mat == 1] = [0, 1, 0]
    for c, r, mid in SPHERES:
        m = mat == mid
        if m.any():
            nn = p[m] - c
            n[m] = nn / (np.linalg.norm(nn, axis=-1, keepdims=True) + 1e-12)
    for lo, hi, mid in BOXES:
        m = mat == mid
        if m.any():
            q = p[m]
            ctr = (lo + hi) / 2
            half = (hi - lo) / 2
            rel = (q - ctr) / half
            axis = np.argmax(np.abs(rel), axis=-1)
            nn = np.zeros_like(q)
            nn[np.arange(len(q)), axis] = np.sign(
                rel[np.arange(len(q)), axis])
            n[m] = nn
    return n


def render_view(eye, target, width, height, fovx, tex_freq=TEX_FREQ, octaves=OCTAVES,
                specular=0.0):
    up = np.array([0.0, 1.0, 0.0])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    upv = np.cross(right, fwd)
    f = width / (2 * np.tan(fovx / 2))
    xs, ys = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    d = ((xs - width / 2)[..., None] * right
         - (ys - height / 2)[..., None] * upv + f * fwd)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, mat = trace(eye, d)
    hit = np.isfinite(t) & (mat > 0)
    p = eye + np.where(hit[..., None], t[..., None], 0.0) * d
    n = normal_at(p, mat, eye)
    alb = albedo(p, mat, tex_freq, octaves)
    lam = np.clip(np.einsum("...i,i->...", n, LIGHT), 0, 1)
    shade = (0.35 + 0.65 * lam)[..., None]
    img = np.where(hit[..., None], alb * shade, 0.0).astype(np.float32)
    if specular > 0:
        # Blinn-Phong half-vector lobe: view-dependent, multi-view
        # consistent (a pure function of hit point + eye), trains f_rest
        h = LIGHT - d  # -d = direction toward the eye
        h = h / (np.linalg.norm(h, axis=-1, keepdims=True) + 1e-12)
        ndh = np.clip(np.einsum("...i,...i->...", n, h), 0, 1)
        spec = np.zeros_like(lam)
        for mid, (ks, pw) in _GLOSS.items():
            m = mat == mid
            if m.any():
                spec[m] = ks * ndh[m] ** pw
        img = img + (hit * specular * spec * (lam > 0))[..., None] \
            * np.array([1.0, 0.97, 0.9], np.float32)
    return np.clip(img, 0, 1), hit.astype(np.float32)


def camera_ring(n, radius=4.6, hmin=0.6, hmax=2.4, seed=0):
    rng = np.random.default_rng(seed)
    eyes = []
    for v in range(n):
        th = 2 * np.pi * v / n
        h = hmin + (hmax - hmin) * (0.5 + 0.5 * np.sin(3 * th + 0.7))
        r = radius * (0.92 + 0.16 * rng.random())
        eyes.append(np.array([r * np.sin(th), h, r * np.cos(th)]))
    return eyes


def surface_points(n, seed=1, tex_freq=TEX_FREQ, octaves=OCTAVES):
    """Init point cloud: samples on the primitives with albedo colors."""
    rng = np.random.default_rng(seed)
    pts, cols = [], []
    # plane
    m = n // 2
    p = np.stack([rng.uniform(-6, 6, m), np.full(m, PLANE_Y),
                  rng.uniform(-6, 6, m)], axis=-1)
    pts.append(p)
    cols.append(albedo(p, np.full(m, 1), tex_freq, octaves))
    per = (n - m) // (len(SPHERES) + len(BOXES))
    for c, r, mid in SPHERES:
        d = rng.normal(size=(per, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = c + r * d
        pts.append(p)
        cols.append(albedo(p, np.full(per, mid), tex_freq, octaves))
    for lo, hi, mid in BOXES:
        p = rng.uniform(lo, hi, (per, 3))
        for i in range(per):  # project to a random face
            ax = rng.integers(0, 3)
            p[i, ax] = lo[ax] if rng.random() < 0.5 else hi[ax]
        pts.append(p)
        cols.append(albedo(p, np.full(per, mid), tex_freq, octaves))
    return np.concatenate(pts), np.concatenate(cols)


def gt_mesh(subdiv: int = 4, plane_half: float = 3.2):
    """Analytic ground-truth mesh of the scene geometry (spheres as
    subdivided icospheres, boxes as 12 triangles, ground plane as a patch):
    the exact reference surface for chamfer/F-score validation of extracted
    meshes (eval/dtu.py, eval/tnt.py, eval_procedural_geometry)."""
    # icosahedron
    t = (1 + 5**0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdiv):
        cache = {}
        nv = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (v[a] + v[b]) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(nv)
                nv.append(m)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(nv)
        f = np.array(nf)
        v /= np.linalg.norm(v, axis=1, keepdims=True)

    verts, faces = [], []

    def add(vv, ff):
        faces.append(np.asarray(ff) + sum(len(x) for x in verts))
        verts.append(np.asarray(vv, np.float64))

    for c, r, _m in SPHERES:
        add(v * r + c, f)
    box_f = np.array([[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7],
                      [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
                      [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7]])
    for lo, hi, _m in BOXES:
        bv = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                       [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                       [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                       [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
        add(bv, box_f)
    # ground plane patch (two triangles per grid cell for even sampling)
    g = np.linspace(-plane_half, plane_half, 33)
    gx, gz = np.meshgrid(g, g, indexing="ij")
    pv = np.stack([gx, np.full_like(gx, PLANE_Y), gz], -1).reshape(-1, 3)
    n = 33
    i0 = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).reshape(-1)
    pf = np.stack([np.stack([i0, i0 + 1, i0 + n], -1),
                   np.stack([i0 + 1, i0 + n + 1, i0 + n], -1)], 1).reshape(-1, 3)
    add(pv, pf)
    return np.concatenate(verts), np.concatenate(faces).astype(np.int64)


TARGET = np.array([0.0, -0.4, 0.0])


def c2w_blender(eye, target):
    """The view's OpenGL camera-to-world, as the Blender json stores it."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    upv = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = upv
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def write_view(out, name, eye, width, height, fovx, tex_freq, octaves, specular):
    """Trace one view and write its RGBA PNG (one thread's task); returns
    the view's frame entry."""
    from PIL import Image

    img, alpha = render_view(eye, TARGET, width, height, fovx, tex_freq, octaves, specular)
    rgba = np.concatenate([img, alpha[..., None]], axis=-1)
    Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
        os.path.join(out, name + ".png"))
    return {"file_path": name, "transform_matrix": c2w_blender(eye, TARGET).tolist()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "gof_proc_scene"))
    ap.add_argument("--width", type=int, default=1237)
    ap.add_argument("--height", type=int, default=822)
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--test-views", type=int, default=6)
    ap.add_argument("--fovx", type=float, default=1.1)
    ap.add_argument("--points", type=int, default=40_000)
    ap.add_argument("--tex-freq", type=float, default=1.0,
                    help="texture frequency multiplier (higher -> more "
                         "densification pressure)")
    ap.add_argument("--octaves", type=int, default=3)
    ap.add_argument("--specular", type=float, default=0.0,
                    help="Blinn-Phong lobe strength (view-dependent shading "
                         "that exercises SH degrees 1-3); 0 = lambertian")
    args = ap.parse_args(argv)

    from gof_tpu_torch.utils import ply

    t0 = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    look = (args.width, args.height, args.fovx, args.tex_freq, args.octaves, args.specular)
    jobs = ([(f"r_{i}", eye) for i, eye in enumerate(camera_ring(args.views, seed=0))]
            + [(f"t_{i}", eye) for i, eye in
               enumerate(camera_ring(args.test_views, radius=4.3, seed=7))])
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    print(f"rendering {args.views} train + {args.test_views} test views "
          f"({workers} threads)...", flush=True)
    with ThreadPoolExecutor(workers) as pool:
        frames = list(pool.map(lambda job: write_view(args.out, *job, *look), jobs))
    tr, te = frames[:args.views], frames[args.views:]
    with open(os.path.join(args.out, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": args.fovx, "frames": tr}, f)
    with open(os.path.join(args.out, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": args.fovx, "frames": te}, f)

    pts, cols = surface_points(args.points, tex_freq=args.tex_freq, octaves=args.octaves)
    jitter = np.random.default_rng(3).normal(size=pts.shape) * 0.01
    c8 = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    p = (pts + jitter).astype(np.float32)
    ply.write_ply(os.path.join(args.out, "points3d.ply"), {
        "x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
        "red": c8[:, 0], "green": c8[:, 1], "blue": c8[:, 2],
    })
    gv, gf = gt_mesh()
    ply.write_ply(os.path.join(args.out, "gt_mesh.ply"), {
        "x": gv[:, 0].astype(np.float32), "y": gv[:, 1].astype(np.float32),
        "z": gv[:, 2].astype(np.float32)}, faces=gf)
    seconds = time.perf_counter() - t0
    print(f"wrote {args.out}: {args.views} train / {args.test_views} test "
          f"views at {args.width}x{args.height}, {len(p)} init points, "
          f"gt_mesh.ply ({len(gv)} verts) in {seconds:.1f} s")
    return {"out": args.out, "width": args.width, "height": args.height,
            "train_views": args.views, "test_views": args.test_views, "points": len(p),
            "gt_verts": len(gv), "seconds": seconds}


if __name__ == "__main__":
    main()
