"""The benchmark's one generator: scenes, cameras, target images, tetra
points and visit orders, all made from `--seed` and a cell's configuration
and traffic files.

Gaussians and images are drawn on the device by a torch.Generator there, in
a few large calls, so the same seed on the same card gives the same inputs.
Camera matrices are built in numpy in float64 and rounded to float32 once,
as GOF's cameras are. Nothing here imports the program: the runner turns
these plain tensors into the program's types, and the reference reads them
as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.gof import View

SEED_MASK = (1 << 63) - 1
SH_C0 = 0.28209479177387814


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator for one stream of the run's inputs (salt tells the
    streams apart), seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------

def _quats(n, g, device):
    q = torch.randn((n, 4), generator=g, device=device)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _opacity_logit(n, lo, hi, g, device):
    op = lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.log(op / (1 - op)).float()


def gaussians(cfg: dict, seed: int, device) -> dict:
    """The model of a configuration: `gaussians` of them, placed as its
    `scene` entry says, on the device.

    kind "frustum_cloud": bench.py's late-training scene: depths uniform in
    [z_min, z_max], x and y uniform inside a frustum of half-widths
    x_spread * z and y_spread * z. kind "object_shell": an object-centred
    cloud, centres at radius shell_radius * (1 + shell_noise * N(0, 1))
    around the origin, as a DTU object lies inside its unit sphere.
    Both: random rotations, log-scales N(log_scale_mean, log_scale_std),
    opacities uniform in [opacity_min, opacity_max], base colours uniform,
    higher SH bands N(0, sh_rest_std), 3D filter `filter_3d`.
    """
    scene = cfg["scene"]
    n = int(cfg["gaussians"])
    K = (int(scene["sh_degree"]) + 1) ** 2
    g = generator(seed, 1, device)
    u = torch.rand((n, 3), generator=g, device=device)
    if scene["kind"] == "frustum_cloud":
        z = scene["z_min"] + (scene["z_max"] - scene["z_min"]) * u[:, 2]
        xyz = torch.stack([(2 * u[:, 0] - 1) * z * scene["x_spread"],
                           (2 * u[:, 1] - 1) * z * scene["y_spread"], z], -1)
    elif scene["kind"] == "object_shell":
        d = torch.randn((n, 3), generator=g, device=device)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        r = scene["shell_radius"] * (1 + scene["shell_noise"]
                                     * torch.randn(n, generator=g, device=device))
        xyz = d * r[:, None]
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    rgb = torch.rand((n, 1, 3), generator=g, device=device)
    rest = scene["sh_rest_std"] * torch.randn((n, K - 1, 3), generator=g, device=device)
    return {
        "xyz": xyz.contiguous(),
        "features_dc": (rgb - 0.5) / SH_C0,
        "features_rest": rest,
        "scaling": scene["log_scale_mean"] + scene["log_scale_std"]
        * torch.randn((n, 3), generator=g, device=device),
        "rotation": _quats(n, g, device),
        "opacity": _opacity_logit(n, scene["opacity_min"], scene["opacity_max"], g, device),
        "filter_3d": torch.full((n,), float(scene["filter_3d"]), device=device),
        "active": torch.ones(n, dtype=torch.bool, device=device),
    }


# --------------------------------------------------------------------------
# cameras
# --------------------------------------------------------------------------

def _projection(znear, zfar, fovx, fovy):
    ty, tx = np.tan(fovy / 2), np.tan(fovx / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def look_at(eye, target, fovx: float, width: int, height: int, device,
            up=(0.0, 1.0, 0.0)) -> View:
    """A camera at `eye` looking at `target` (x right, y down, z forward),
    with GOF's clip planes 0.01 and 100."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, :3] = R.T.astype(np.float32)
    w2v[:3, 3] = (-R.T @ eye).astype(np.float32)
    fovy = 2 * np.arctan(np.tan(fovx / 2) * height / width)
    full = (_projection(0.01, 100.0, fovx, fovy) @ w2v).astype(np.float32)
    center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return View(int(width), int(height), f32(w2v), f32(full), f32(center),
                f32(np.tan(fovx / 2)), f32(np.tan(fovy / 2)))


def views(cams: dict, device, split: str = "all") -> list:
    """The configuration's cameras of one split. kind "ellipse": bench.py's
    orbit, eyes (a sin th, b cos th, 0) for th evenly in [-th_max, th_max],
    looking at `target`. kind "cap": eyes on a sphere of `radius` around the
    origin at polar angles up to `polar_max` (a Fibonacci spiral), looking at
    the origin, as DTU's cameras face its object from one side.

    split "all": every camera; with `llffhold` k, "test" holds every k-th
    camera from the first and "train" the others, as GOF's --eval splits a
    Mip-NeRF 360 scene."""
    n, W, H, fov = int(cams["count"]), int(cams["width"]), int(cams["height"]), cams["fovx"]
    out = []
    if cams["kind"] == "ellipse":
        for th in np.linspace(-cams["th_max"], cams["th_max"], n):
            out.append(look_at((cams["a"] * np.sin(th), cams["b"] * np.cos(th), 0.0),
                               cams["target"], fov, W, H, device))
    elif cams["kind"] == "cap":
        golden = np.pi * (3 - np.sqrt(5))
        for i in range(n):
            cos_p = 1 - (1 - np.cos(cams["polar_max"])) * (i + 0.5) / n
            sin_p = np.sqrt(1 - cos_p ** 2)
            eye = cams["radius"] * np.array([sin_p * np.cos(golden * i), -cos_p,
                                             sin_p * np.sin(golden * i)])
            out.append(look_at(eye, (0.0, 0.0, 0.0), fov, W, H, device, up=(0.0, 0.0, 1.0)))
    else:
        raise ValueError(f"unknown camera kind {cams['kind']!r}")
    if split == "all":
        return out
    hold = int(cams["llffhold"])
    if split not in ("train", "test"):
        raise ValueError(f"unknown split {split!r}")
    return [v for i, v in enumerate(out) if (i % hold == 0) == (split == "test")]


def targets(seed: int, n: int, width: int, height: int, device) -> torch.Tensor:
    """[n, 3, H, W] target images, uniform in [0, 1] (bench.py's)."""
    g = generator(seed, 2, device)
    return torch.rand((n, 3, height, width), generator=g, device=device)


def epoch_order(seed: int, epoch: int, n_views: int) -> list:
    """The views of one epoch in a seeded random order, fresh each epoch, as
    train.py draws its cameras."""
    return [int(v) for v in np.random.default_rng([int(seed) & SEED_MASK, 3, epoch])
            .permutation(n_views)]


def sample(seed: int, salt: int, n: int, k: int) -> np.ndarray:
    """k distinct indices of range(n), drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, salt])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


# --------------------------------------------------------------------------
# tetra points of the opacity field's mesh extraction
# --------------------------------------------------------------------------

_BOX = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)


def _rot(q):
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


@torch.no_grad()
def tetra_points(model: dict, cams: list, near: float = 0.02, far: float = 1e6) -> torch.Tensor:
    """GOF's get_tetra_points: per gaussian the 8 corners of its box at 3x
    the 3D-filtered scale and its centre, kept where some view sees them
    (depth in [near, far], pixel inside the image). [N, 3] on the device."""
    xyz, rot = model["xyz"], model["rotation"]
    scale = torch.sqrt(torch.exp(model["scaling"]) ** 2 + model["filter_3d"][:, None] ** 2) * 3.0
    box = torch.as_tensor(_BOX, device=xyz.device)
    corners = xyz[:, None, :] + torch.einsum("pij,pcj->pci", _rot(rot), box[None] * scale[:, None])
    pts = torch.cat([corners.reshape(-1, 3), xyz], 0)
    seen = torch.zeros(len(pts), dtype=torch.bool, device=xyz.device)
    for v in cams:
        pv = pts @ v.world_view[:3, :3].T + v.world_view[:3, 3]
        z = pv[:, 2]
        zc = torch.clamp_min(z, 1e-6)
        u = pv[:, 0] / zc * v.focal_x + v.width / 2.0
        w = pv[:, 1] / zc * v.focal_y + v.height / 2.0
        seen |= ((z >= near) & (z <= far) & (u >= 0) & (u <= v.width - 1)
                 & (w >= 0) & (w <= v.height - 1))
    return pts[seen].contiguous()
