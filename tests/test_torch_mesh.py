"""gof_tpu_torch's mesh extraction (marching tets, tetra points, Delaunay
cache, opacity field, the level-set mesh and its CLI) against gof_tpu.

Marching tets is exact: both of the port's paths give gof_tpu's edge list
and face set. The field is held to gof_tpu's dense twin at atol 1e-5 /
rtol 1e-4. End to end, the port's CPU extraction and gof_tpu's (Pallas in
interpret mode) are fed the same tetra points; once no tetra point's field
lies within 1e-4 of the 0.5 level (so no sign can flip between them), the
crossing edges and faces must be identical and >= 99% of the vertices
within one final bisection interval.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gof_tpu import cameras as jcam
from gof_tpu.mesh import extract as jex
from gof_tpu.mesh import tetmesh as jtm
from gof_tpu.model import gaussians as jgm
from gof_tpu.ops import integrate as ji
from gof_tpu.ops import quadrics as jq
from gof_tpu.utils import ply as jply
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import extract_mesh
from gof_tpu_torch.data import scene as tscene
from gof_tpu_torch.mesh import extract as tex
from gof_tpu_torch.mesh import tetmesh as ttm
from gof_tpu_torch.model import gaussians as tgm
from gof_tpu_torch.utils import ply as tply

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def grid_tets(n=12, lo=-1.5, hi=1.5):
    """Regular grid tetrahedralized by Delaunay (as tests/test_mesh.py)."""
    from scipy.spatial import Delaunay

    xs = np.linspace(lo, hi, n)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    return pts.astype(np.float32), Delaunay(pts).simplices.astype(np.int32)


def port_mt(path, pts, tets, sdf, scales):
    """The port's marching tets on its numpy path, or on its torch path
    (tensor inputs, here on the CPU)."""
    if path == "torch":
        tets, sdf = torch.from_numpy(tets), torch.from_numpy(np.asarray(sdf))
    return ttm.marching_tetrahedra(pts, tets, sdf, scales)


def assert_same_mesh(got, want, same_rows):
    for k in ("edge_verts", "edge_points", "edge_sdf", "edge_scale"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["faces"]) == len(want["faces"])
    assert {tuple(f) for f in got["faces"].tolist()} == {tuple(f) for f in want["faces"].tolist()}
    if same_rows:
        np.testing.assert_array_equal(got["faces"], want["faces"])


def test_case_tables_match():
    np.testing.assert_array_equal(ttm.EDGES, jtm.EDGES)
    np.testing.assert_array_equal(ttm.PADDED_TABLE, jtm.PADDED_TABLE)
    assert all(np.array_equal(a, b) for a, b in zip(ttm.CASE_TABLE, jtm.CASE_TABLE))


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_sphere_matches(path):
    pts, tets = grid_tets()
    sdf = (np.linalg.norm(pts, axis=-1) - 1.0).astype(np.float32)
    ones = np.ones(len(pts), np.float32)
    want = jtm._marching_tetrahedra_np(pts, tets, sdf, ones)
    got = port_mt(path, pts, tets, sdf, ones)
    assert len(got["faces"]) > 100
    assert_same_mesh(got, want, same_rows=path == "numpy")


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_offset_sphere_edge_list_exact(path):
    pts, tets = grid_tets(n=8)
    sdf = (np.linalg.norm(pts - np.array([0.2, -0.1, 0.05]), axis=-1) - 0.9).astype(np.float32)
    scales = np.random.default_rng(0).uniform(0.5, 1.5, len(pts)).astype(np.float32)
    want = jtm._marching_tetrahedra_np(pts, tets, sdf, scales)
    got = port_mt(path, pts, tets, sdf, scales)
    assert_same_mesh(got, want, same_rows=path == "numpy")
    assert np.all(got["edge_sdf"][:, 0] * got["edge_sdf"][:, 1] <= 0)


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_empty_and_full(path):
    pts, tets = grid_tets(n=6)
    for sign in (1.0, -1.0):
        out = port_mt(path, pts, tets, np.full(len(pts), sign, np.float32), None)
        want = jtm._marching_tetrahedra_np(pts, tets, np.full(len(pts), sign), None)
        for k in out:
            assert out[k].shape == want[k].shape == (0,) + want[k].shape[1:], k


def known_scene(rng, n=8, views=6, size=64, far_gaussian=False):
    """test_mesh_from_known_gaussians' scene: n gaussians near the origin,
    cameras on a ring of radius 3. Returns gof_tpu (params, state, cams,
    cam_meta) and the port's counterparts."""
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    if far_gaussian:
        means[-1] = [0.0, 40.0, 0.0]  # above every camera's frustum
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    op = np.full((n,), 0.95, np.float32)
    dc = (np.full((n, 1, 3), 0.5, np.float32) - 0.5) / 0.28209479177387814
    params = dict(xyz=means, features_dc=dc.astype(np.float32),
                  features_rest=np.zeros((n, 0, 3), np.float32),
                  scaling=np.log(np.full((n, 3), 0.25, np.float32)),
                  rotation=q.astype(np.float32), opacity=np.log(op / (1 - op)))
    z = np.zeros((n,), np.float32)
    state = dict(active=np.ones((n,), bool), filter_3d=z + 1e-4, max_radii2d=z,
                 grad_accum=z, grad_abs_accum=z, denom=z)
    eyes = [(3.0 * np.sin(a), 1.0, 3.0 * np.cos(a))
            for a in np.linspace(0, 2 * np.pi, views, endpoint=False)]
    jcams = [jcam.look_at_camera(eye=e, target=(0, 0, 0), width=size, height=size, uid=i)
             for i, e in enumerate(eyes)]
    tcams = [tcam.look_at_camera(eye=e, target=(0, 0, 0), width=size, height=size, uid=i)
             for i, e in enumerate(eyes)]
    jmeta = (jnp.stack([c.world_view for c in jcams]), jnp.stack([c.focal_x for c in jcams]),
             jnp.stack([c.focal_y for c in jcams]), jnp.full((views,), float(size)),
             jnp.full((views,), float(size)))
    tmeta = (torch.stack([c.world_view for c in tcams]), torch.stack([c.focal_x for c in tcams]),
             torch.stack([c.focal_y for c in tcams]), torch.full((views,), float(size)),
             torch.full((views,), float(size)))
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    js = jgm.GaussianState(**{k: jnp.asarray(v) for k, v in state.items()})
    tp, ts = tgm.from_numpy(jgm.GaussianParams(**params), jgm.GaussianState(**state))
    return (jp, js, jcams, jmeta), (tp, ts, tcams, tmeta)


def test_frustum_mask_and_tetra_points_match():
    rng = np.random.default_rng(1)
    (jp, js, _, jmeta), (tp, ts, _, tmeta) = known_scene(rng, n=12, far_gaussian=True)
    pts = (rng.uniform(-1, 1, (500, 3)) * [6.0, 6.0, 6.0]).astype(np.float32)
    want = np.asarray(jex.frustum_mask(jnp.asarray(pts), *jmeta))
    got = tex.frustum_mask(torch.from_numpy(pts), *tmeta).numpy()
    assert 0 < want.sum() < len(pts)
    np.testing.assert_array_equal(got, want)

    jpts, jscale = jex.get_tetra_points(jp, js, jmeta)
    tpts, tscale = tex.get_tetra_points(tp, ts, tmeta)
    assert 50 < len(jpts) <= 9 * 11 and not (jpts[:, 1] > 30).any()  # the far box is masked
    np.testing.assert_allclose(tpts, jpts, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tscale, jscale, atol=1e-6, rtol=1e-6)


def test_delaunay_cache_interchangeable(tmp_path, monkeypatch):
    pts = np.random.default_rng(2).uniform(-1, 1, (300, 3)).astype(np.float32)
    a, b = str(tmp_path / "a" / "cells.npy"), str(tmp_path / "b" / "cells.npy")
    fresh = jex.delaunay(pts, a)  # gof_tpu writes, the port reads
    np.testing.assert_array_equal(tex.delaunay(pts, b), fresh)  # the port writes

    def no_qhull(*_, **__):
        raise AssertionError("the cache should have been read")

    import scipy.spatial

    monkeypatch.setattr(scipy.spatial, "Delaunay", no_qhull)
    np.testing.assert_array_equal(tex.delaunay(pts, a), fresh)
    np.testing.assert_array_equal(jex.delaunay(pts, b), fresh)
    with pytest.raises(AssertionError):  # a cache for another count is ignored
        tex.delaunay(pts[:-1], a)


def test_field_alpha_matches_dense_min_over_views():
    """FieldEvaluator.alpha against 1 - min over views of (1 - T) from
    gof_tpu's dense twin, on large gaussians whose tile rects cover the
    image (so the tiled and dense paths see the same gaussians)."""
    rng = np.random.default_rng(3)
    n = 10
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(4, 6, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4))
    op = rng.uniform(0.5, 0.95, n)
    params = jgm.GaussianParams(
        xyz=means, features_dc=np.zeros((n, 1, 3), np.float32),
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(rng.uniform(0.4, 0.9, (n, 3))).astype(np.float32),
        rotation=(q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
        opacity=np.log(op / (1 - op)).astype(np.float32))
    z = np.zeros((n,), np.float32)
    state = jgm.GaussianState(active=np.ones((n,), bool), filter_3d=z + 1e-3, max_radii2d=z,
                              grad_accum=z, grad_abs_accum=z, denom=z)
    eyes = [(0, 0, 0), (0.5, 0.2, 0.0), (-0.4, -0.3, 0.5)]
    pts = (rng.uniform(-1, 1, (300, 3)) + [0, 0, 5.0]).astype(np.float32)

    jpar = jgm.GaussianParams(*(jnp.asarray(x) for x in params))
    scales = jgm.filtered_scaling(jpar, jnp.asarray(state.filter_3d))
    opf = jgm.filtered_opacity(jpar, jnp.asarray(state.filter_3d))
    final = jnp.ones(len(pts))
    for e in eyes:
        cam = jcam.look_at_camera(eye=e, target=(0, 0, 5.0), width=64, height=64)
        pre = jq.preprocess(jpar.xyz, scales, jpar.rotation, jnp.zeros((n, 1, 3)), 0, cam, 0.1)
        op_eff = opf * jnp.where(pre.valid, pre.coef, 0.0)
        T = ji.integrate_transmittance_dense(jnp.asarray(pts), cam, op_eff, pre.v2g_M,
                                             pre.v2g_u0, pre.valid)
        final = jnp.minimum(final, 1.0 - T)
    want = np.asarray(1.0 - final)

    tp, ts = tgm.from_numpy(params, state)
    cams = [tcam.look_at_camera(eye=e, target=(0, 0, 5.0), width=64, height=64) for e in eyes]
    got = tex.FieldEvaluator(tp, ts, cams, 0, 0.1).alpha(pts)
    assert got.dtype == np.float32 and got.shape == (len(pts),)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert want.min() < 0.5 < want.max()
    # the points split over three CPU shards (gof_tpu's `mesh`) give the same bits
    np.testing.assert_array_equal(
        tex.FieldEvaluator(tp, ts, cams, 0, 0.1, devices=["cpu"] * 3).alpha(pts), got)


def test_field_jumps_to_one_at_the_image_border():
    """Reference behaviour (ROADMAP C10): a point that projects outside a
    view's image has T = 1 in that view, so the field (max over views of T)
    jumps to 1 across every training view's image border, in both packages.
    One broad opaque gaussian at depth 5 covers the image; points at depth 8
    cross the image's left and right borders."""
    params = jgm.GaussianParams(
        xyz=np.array([[0.0, 0.0, 5.0]], np.float32),
        features_dc=np.zeros((1, 1, 3), np.float32), features_rest=np.zeros((1, 0, 3), np.float32),
        scaling=np.log(np.array([[3.0, 3.0, 0.3]], np.float32)),
        rotation=np.array([[1.0, 0, 0, 0]], np.float32),
        opacity=np.array([np.log(0.95 / 0.05)], np.float32))
    z = np.zeros((1,), np.float32)
    state = jgm.GaussianState(active=np.ones((1,), bool), filter_3d=z + 1e-4, max_radii2d=z,
                              grad_accum=z, grad_abs_accum=z, denom=z)
    xs = np.linspace(-3.6, 3.6, 2001)
    pts = np.stack([xs, 0 * xs, 0 * xs + 8.0], -1).astype(np.float32)
    kw = dict(eye=(0, 0, 0), target=(0, 0, 5.0), width=64, height=64)

    tp, ts = tgm.from_numpy(params, state)
    got = tex.FieldEvaluator(tp, ts, [tcam.look_at_camera(**kw)], 0, 0.1).alpha(pts)
    jpar = jgm.GaussianParams(*(jnp.asarray(x) for x in params))
    cam = jcam.look_at_camera(**kw)
    filt = jnp.asarray(state.filter_3d)
    pre = jq.preprocess(jpar.xyz, jgm.filtered_scaling(jpar, filt), jpar.rotation,
                        jnp.zeros((1, 1, 3)), 0, cam, 0.1)
    op_eff = jgm.filtered_opacity(jpar, filt) * jnp.where(pre.valid, pre.coef, 0.0)
    want = np.asarray(ji.integrate_transmittance_dense(jnp.asarray(pts), cam, op_eff, pre.v2g_M,
                                                       pre.v2g_u0, pre.valid))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    jumps = np.abs(np.diff(got))
    assert got[1000] < 0.5 and got[0] == got[-1] == 1.0
    assert (jumps > 0.4).sum() == 2  # one wall at each border; elsewhere the field is smooth
    assert np.sort(jumps)[-3] < 0.01


def test_extract_matches_gof_tpu(tmp_path, monkeypatch):
    steps = 4
    (jp, js, jcams, jmeta), (tp, ts, tcams, tmeta) = known_scene(np.random.default_rng(0))
    pts, pscale = jex.get_tetra_points(jp, js, jmeta)
    monkeypatch.setattr(tex, "get_tetra_points", lambda *a, **k: (pts, pscale))

    ev = tex.FieldEvaluator(tp, ts, tcams, 0, 0.1)
    alpha = ev.alpha(pts)
    assert np.abs(alpha - 0.5).min() > 1e-4  # no sign can flip between the packages
    mt = ttm.marching_tetrahedra(pts, tex.delaunay(pts), alpha - 0.5, pscale)
    interval = float(np.linalg.norm(mt["edge_points"][:, 0] - mt["edge_points"][:, 1],
                                    axis=-1).min()) / 2**steps

    jpath = jex.extract_level_set_mesh(jp, js, jcams, jmeta, str(tmp_path / "jax"),
                                       sh_degree=0, kernel_size=0.1, key_capacity=2048,
                                       n_binary_steps=steps, interpret=True, quiet=True)
    res = tex.extract_level_set_mesh(tp, ts, tcams, tmeta, str(tmp_path / "torch"),
                                     sh_degree=0, kernel_size=0.1, n_binary_steps=steps,
                                     quiet=True)
    jv, jf = jply.read_ply(jpath)
    tv, tf = tply.read_ply(res["path"])
    assert res["path"].endswith("mesh_binary_search_3.ply")
    assert res["crossing_edges"] == len(mt["edge_points"]) and res["faces"] == len(tf) > 50
    assert res["tetra_points"] == len(pts) and res["vertices"] == len(tv["x"])
    assert set(res["seconds"]) == {"tetra_points", "delaunay", "field", "marching_tets", "ply",
                                   *(f"bisection_{i}" for i in range(steps))}
    np.testing.assert_array_equal(tf, jf)
    jverts = np.stack([jv["x"], jv["y"], jv["z"]], -1)
    tverts = np.stack([tv["x"], tv["y"], tv["z"]], -1)
    assert tverts.shape == jverts.shape
    assert np.mean(np.abs(tverts - jverts).max(axis=-1) <= interval) >= 0.99
    # gof_tpu's own end-to-end bound: the field at the vertices is ~0.5
    assert np.quantile(np.abs(ev.alpha(tverts) - 0.5), 0.9) < 0.15


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    """A model directory: the known scene's 8 gaussians as a PLY at
    iteration 5, and a Blender source scene of 4 views at 48x48."""
    root = tmp_path_factory.mktemp("mesh_cli")
    src, model = str(root / "scene"), str(root / "model")
    os.makedirs(os.path.join(src, "images"))
    (_, _, _, _), (tp, ts, tcams, _) = known_scene(np.random.default_rng(0), views=4, size=48)
    frames = []
    for i, cam in enumerate(tcams):
        c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes
        Image.fromarray(np.full((48, 48, 3), 30 * i, np.uint8)).save(
            os.path.join(src, "images", f"{i}.png"))
        frames.append({"file_path": f"images/{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    tscene.save_gaussians_ply(os.path.join(model, "point_cloud", "iteration_5", "point_cloud.ply"),
                              tp, ts, 0)
    tconfig.save_cfg(model, tconfig.ModelParams(source_path=src, model_path=model, sh_degree=0,
                                                kernel_size=0.1),
                     tconfig.PipelineParams(), tconfig.OptimizationParams())
    return model


def test_extract_mesh_cli_cpu(tiny_model):
    res = extract_mesh.main(["-m", tiny_model, "--cpu", "--texture_mesh"])
    path = os.path.join(tiny_model, "test", "ours_5", "fusion", "mesh_binary_search_7.ply")
    assert res["path"] == path and os.path.exists(path)
    verts, faces = tply.read_ply(path)
    v = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    assert len(faces) == res["faces"] > 20 and len(v) == res["vertices"]
    assert np.isfinite(v).all() and faces.max() < len(v)
    assert {"red", "green", "blue"} <= set(verts) and verts["red"].max() > 0
    assert {"colors", "bisection_7"} <= set(res["seconds"])


def test_extract_mesh_cli_refusals(tiny_model, monkeypatch):
    """--shard N needs N CUDA devices (never shares a card or falls back to
    the CPU on its own); without --cpu the CLI needs CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--shard 2 needs 2 devices; only 1 visible"):
        extract_mesh.main(["-m", tiny_model, "--shard", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_mesh.main(["-m", tiny_model])


def test_extract_mesh_cli_shards_the_field(tiny_model, tmp_path):
    """--cpu --shard 2 splits the field's points over two CPU shards and
    writes the unsharded mesh."""
    path = os.path.join(tiny_model, "test", "ours_5", "fusion", "mesh_binary_search_7.ply")
    res1 = extract_mesh.main(["-m", tiny_model, "--cpu"])
    one = tply.read_ply(path)
    res2 = extract_mesh.main(["-m", tiny_model, "--cpu", "--shard", "2"])
    two = tply.read_ply(path)
    assert res2["faces"] == res1["faces"] > 20
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(two[0][k], one[0][k])
    np.testing.assert_array_equal(two[1], one[1])
