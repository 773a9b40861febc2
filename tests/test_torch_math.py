"""gof_tpu_torch math core against gof_tpu: transforms, SH, cameras.

Inputs are made with numpy from a seed and fed to both packages; every
comparison uses atol 1e-6 (f32 arithmetic in the same operation order),
plus rtol 1e-6 for the matmul-based point maps, which may sum in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import sh as jsh
from gof_tpu import transforms as jtf
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import sh as tsh
from gof_tpu_torch import transforms as ttf

torch.set_num_threads(2)

ATOL = 1e-6


def close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy() if
                               isinstance(b, torch.Tensor) else np.asarray(b),
                               atol=atol, rtol=rtol)


class TestTransforms:
    def test_quat_to_rot(self, rng):
        q = rng.normal(size=(64, 4)).astype(np.float32)
        close(jtf.quat_to_rot(jnp.asarray(q)), ttf.quat_to_rot(torch.from_numpy(q)))

    def test_world_to_view_and_projection(self, rng):
        R = jtf.quat_to_rot(jnp.asarray(rng.normal(size=4), jnp.float32))
        t = rng.normal(size=3)
        np.testing.assert_array_equal(jtf.world_to_view(np.asarray(R), t),
                                      ttf.world_to_view(np.asarray(R), t))
        np.testing.assert_array_equal(jtf.projection_matrix(0.01, 100.0, 0.8, 0.6),
                                      ttf.projection_matrix(0.01, 100.0, 0.8, 0.6))
        assert ttf.fov_to_focal(0.8, 640) == jtf.fov_to_focal(0.8, 640)
        assert ttf.focal_to_fov(500.0, 640) == jtf.focal_to_fov(500.0, 640)

    def test_point_maps(self, rng):
        # matmuls may sum in another order: 1e-6 relative on top of atol
        pts = (rng.normal(size=(32, 3)) + [0, 0, 5]).astype(np.float32)
        m = rng.normal(size=(4, 4)).astype(np.float32)
        proj = np.array(jcam.look_at_camera(eye=(0.1, 0, 0), target=(0, 0, 5.0)).full_proj)
        close(jtf.project_points(jnp.asarray(pts), jnp.asarray(proj)),
              ttf.project_points(torch.from_numpy(pts), torch.from_numpy(proj)), rtol=1e-6)
        close(jtf.transform_points(jnp.asarray(pts), jnp.asarray(m)),
              ttf.transform_points(torch.from_numpy(pts), torch.from_numpy(m)), rtol=1e-6)
        v = rng.uniform(-1, 1, 50).astype(np.float32)
        close(jtf.ndc_to_pixel(jnp.asarray(v), 96), ttf.ndc_to_pixel(torch.from_numpy(v), 96))


class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_eval_sh(self, rng, degree):
        sh = rng.normal(size=(40, 16, 3)).astype(np.float32)
        d = rng.normal(size=(40, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        close(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)),
              tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(d)))

    def test_sh_to_rgb_and_dc(self, rng):
        sh = rng.normal(size=(40, 16, 3)).astype(np.float32) * 0.3
        means = rng.normal(size=(40, 3)).astype(np.float32)
        cam = np.array([0.1, -0.2, -3.0], np.float32)
        close(jsh.sh_to_rgb(3, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(cam)),
              tsh.sh_to_rgb(3, torch.from_numpy(sh), torch.from_numpy(means),
                            torch.from_numpy(cam)))
        rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
        close(jsh.rgb_to_sh_dc(jnp.asarray(rgb)), tsh.rgb_to_sh_dc(torch.from_numpy(rgb)))
        close(jsh.sh_dc_to_rgb(jnp.asarray(rgb)), tsh.sh_dc_to_rgb(torch.from_numpy(rgb)))


def _same_camera(cj, ct):
    assert (cj.width, cj.height) == (ct.width, ct.height)
    for name in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy",
                 "focal_x", "focal_y"):
        close(getattr(cj, name), getattr(ct, name))


class TestCameras:
    @pytest.mark.parametrize("size", [(96, 64), (1237, 822)])
    def test_look_at_camera(self, size):
        kw = dict(eye=(0.3, -0.1, 0.2), target=(0, 0, 5.0), width=size[0], height=size[1])
        _same_camera(jcam.look_at_camera(**kw), tcam.look_at_camera(**kw))

    def test_make_camera(self, rng):
        R = np.asarray(jtf.quat_to_rot(jnp.asarray(rng.normal(size=4), jnp.float32)))
        t = rng.normal(size=3)
        cj = jcam.make_camera(R, t, 0.9, 0.7, 160, 120, uid=3)
        ct = tcam.make_camera(R, t, 0.9, 0.7, 160, 120, uid=3)
        _same_camera(cj, ct)
        assert ct.uid == 3 and ct.world_view.device == torch.device("cpu")
