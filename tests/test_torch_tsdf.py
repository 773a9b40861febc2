"""TSDF fusion of gof_tpu_torch against gof_tpu's (mesh/tsdf.py and the
extract_mesh_tsdf CLI).

Both packages fuse the same numpy depth maps (analytic sphere depths) seen
by the same cameras. Tolerances: discover_blocks equal exactly; tsdf,
weight and color within 1e-5 where both sides updated the same samples,
with the samples whose update flipped (a projection or an sdf that rounds
to the other side of an image edge or of -1 in f32) counted and held under
1e-4 of them; the mesh functions on the same grids give the same vertices
within 1e-5 and the same set of faces (the port's marching tets emit
faces in tet order, gof_tpu's numpy path by case).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import extract_mesh_tsdf as jcli
from gof_tpu.mesh import tsdf as jtsdf
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import extract_mesh_tsdf as tcli
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.mesh import tsdf as ttsdf
from gof_tpu_torch.utils import ply

from make_synthetic_scene import make_scene
from test_tsdf import sphere_depth

torch.set_num_threads(2)

FLIP_SHARE = 1e-4


def ring(n=8, size=96, radius=2.5):
    """gof_tpu's and the port's cameras on test_tsdf's ring."""
    kw = [dict(eye=(radius * np.sin(th), 0.8, radius * np.cos(th)), target=(0, 0, 0),
               width=size, height=size, uid=i)
          for i, th in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False))]
    return [jcam.look_at_camera(**k) for k in kw], [tcam.look_at_camera(**k) for k in kw]


@pytest.fixture(scope="module")
def sphere_views():
    center, radius = np.array([0.05, -0.03, 0.02]), 0.45
    jcams, tcams = ring()
    depths = [sphere_depth(c, center, radius) for c in jcams]
    rng = np.random.default_rng(0)
    colors = [rng.uniform(0, 1, (3, 96, 96)).astype(np.float32) for _ in depths]
    return jcams, tcams, depths, colors, center, radius


def held(got, want, w_got, w_want, what):
    """Samples both sides updated alike within 1e-5; the flipped ones
    counted (printed) and under FLIP_SHARE of all."""
    got, want = np.asarray(got), np.asarray(want)
    same = np.asarray(w_got) == np.asarray(w_want)
    flipped = int((~same).sum())
    print(f"{what}: {flipped} of {same.size} samples flipped")
    assert flipped <= FLIP_SHARE * same.size, flipped
    np.testing.assert_allclose(got[same], want[same], atol=1e-5, rtol=0)
    return flipped


def same_faces(verts_a, faces_a, verts_b, faces_b):
    np.testing.assert_allclose(verts_a, verts_b, atol=1e-5, rtol=0)
    key = lambda f: np.unique(np.sort(f, axis=1), axis=0)  # noqa: E731
    np.testing.assert_array_equal(key(faces_a), key(faces_b))


def test_fuse_depth_maps_and_grid_to_mesh_match(sphere_views):
    jcams, tcams, depths, _, _, _ = sphere_views
    lo = np.array([-0.8, -0.8, -0.8], np.float32)
    args = (lo, 0.025, (65, 65, 65), 0.1, 0.3, 6.0)
    jt, jw = jtsdf.fuse_depth_maps(depths, jcams, *args, slab=16)
    tt, tw = ttsdf.fuse_depth_maps(depths, tcams, *args, slab=16)
    assert tt.shape == (65, 65, 65) and tt.dtype == torch.float32
    assert (jw > 0).sum() > 10_000
    held(tt.numpy(), jt, tw.numpy(), jw, "dense tsdf")
    # the mesh of gof_tpu's grid, in both packages
    jv, jf = jtsdf.grid_to_mesh(jt, jw, lo, 0.025)
    tv, tf = ttsdf.grid_to_mesh(torch.from_numpy(jt), torch.from_numpy(jw), lo, 0.025)
    assert len(jv) > 200
    same_faces(tv, tf, jv, jf)


def test_sparse_blocks_fuse_and_mesh_match(sphere_views):
    jcams, tcams, depths, colors, _, _ = sphere_views
    kw = dict(block_res=8, sdf_trunc=0.08, depth_min=0.3, depth_max=6.0)
    jb = jtsdf.discover_blocks(depths, jcams, 0.01, **kw)
    tb = ttsdf.discover_blocks([torch.from_numpy(d) for d in depths], tcams, 0.01, **kw)
    assert tb.dtype == torch.int32 and len(jb) > 100
    np.testing.assert_array_equal(tb.numpy(), jb)  # np.unique's row order
    jt, jw, jc = jtsdf.fuse_blocks(depths, colors, jcams, jb, 0.01, batch=64, **kw)
    tt, tw, tc = ttsdf.fuse_blocks(depths, colors, tcams, tb, 0.01, batch=64, **kw)
    assert tt.shape == (len(jb), 9**3) and tc.shape == (len(jb), 9**3, 3)
    held(tt.numpy(), jt, tw.numpy(), jw, "sparse tsdf")
    held(tw.numpy(), jw, tw.numpy(), jw, "sparse weight")
    held(tc.numpy().reshape(-1, 3), jc.reshape(-1, 3), tw.numpy().reshape(-1),
         jw.reshape(-1), "sparse color")
    # the mesh of gof_tpu's blocks, in both packages
    jv, jf, jvc = jtsdf.blocks_to_mesh(jt, jw, jc, jb, 0.01, block_res=8)
    tv, tf, tvc = ttsdf.blocks_to_mesh(torch.from_numpy(jt), torch.from_numpy(jw),
                                       torch.from_numpy(jc), torch.from_numpy(jb), 0.01,
                                       block_res=8)
    assert len(jv) > 500
    same_faces(tv, tf, jv, jf)
    np.testing.assert_allclose(tvc, jvc, atol=1e-5, rtol=0)
    # without color
    tv2, tf2, none = ttsdf.blocks_to_mesh(torch.from_numpy(jt), torch.from_numpy(jw), None,
                                          torch.from_numpy(jb), 0.01, block_res=8)
    assert none is None
    same_faces(tv2, tf2, jv, jf)


def test_empty_inputs_give_empty_meshes():
    _, tcams = ring(n=2, size=16)
    empty = [np.zeros((16, 16), np.float32)] * 2
    blocks = ttsdf.discover_blocks(empty, tcams, 0.01)
    assert blocks.shape == (0, 3)
    t, w, c = ttsdf.fuse_blocks(empty, None, tcams, blocks, 0.01)
    v, f, vc = ttsdf.blocks_to_mesh(t, w, c, blocks, 0.01)
    assert v.shape == (0, 3) and f.shape == (0, 3) and vc is None
    t, w = ttsdf.fuse_depth_maps(empty, tcams, np.zeros(3), 0.1, (4, 4, 4), 0.1)
    assert (t == 1).all() and (w == 0).all()
    assert ttsdf.grid_to_mesh(t, w, np.zeros(3), 0.1)[0].shape == (0, 3)
    with pytest.raises(RuntimeError, match="max_blocks"):
        d = [np.full((16, 16), 2.0, np.float32)] * 2
        ttsdf.discover_blocks(d, tcams, 0.01, max_blocks=3)


# ---------------------------------------------------------------------------
# Ports of tests/test_tsdf.py (sphere reconstruction by the port alone)
# ---------------------------------------------------------------------------


def test_sphere_reconstruction(sphere_views):
    """tests/test_tsdf.py:29 on the port."""
    jcams, tcams, _, _, _, _ = sphere_views
    center, radius = np.zeros(3), 0.5
    depths = [sphere_depth(c, center, radius) for c in jcams]
    lo = np.array([-0.8, -0.8, -0.8], np.float32)
    voxel = 0.025
    tsdf, weight = ttsdf.fuse_depth_maps(depths, tcams, lo, voxel, (65, 65, 65), sdf_trunc=0.1,
                                         depth_min=0.3, depth_max=6.0)
    tsdf, weight = tsdf.numpy(), weight.numpy()
    p_in = center + np.array([radius - 1.5 * voxel, 0, 0])
    p_out = center + np.array([radius + 1.5 * voxel, 0, 0])
    vi = tuple(((p_in - lo) / voxel).astype(int))
    vo = tuple(((p_out - lo) / voxel).astype(int))
    assert weight[vi] > 0 and tsdf[vi] < 0, (tsdf[vi], weight[vi])
    assert weight[vo] > 0 and tsdf[vo] > 0, (tsdf[vo], weight[vo])
    verts, faces = ttsdf.grid_to_mesh(torch.from_numpy(tsdf), torch.from_numpy(weight), lo, voxel)
    assert len(verts) > 200 and len(faces) > 200
    r = np.linalg.norm(verts - center, axis=-1)
    assert abs(np.median(r) - radius) < 1.5 * voxel
    assert np.quantile(np.abs(r - radius), 0.9) < 3 * voxel


def test_sparse_sphere_matches_protocol(sphere_views):
    """tests/test_tsdf.py:76 on the port: fine voxel, sparse band, fused
    color."""
    jcams, tcams, _, _, _, _ = sphere_views
    center, radius, voxel = np.zeros(3), 0.5, 0.01
    trunc = 8 * voxel
    depths = [sphere_depth(c, center, radius) for c in jcams]
    colors = [np.tile(np.array([0.8, 0.1, 0.2], np.float32)[:, None, None], (1, 96, 96))
              for _ in depths]
    blocks = ttsdf.discover_blocks(depths, tcams, voxel, block_res=16, sdf_trunc=trunc,
                                   depth_min=0.3, depth_max=6.0)
    assert 0 < len(blocks) < (5.0 / (16 * voxel)) ** 3 * 0.2
    tsdf, weight, color = ttsdf.fuse_blocks(depths, colors, tcams, blocks, voxel, block_res=16,
                                            sdf_trunc=trunc, depth_min=0.3, depth_max=6.0,
                                            batch=256)
    verts, faces, vcol = ttsdf.blocks_to_mesh(tsdf, weight, color, blocks, voxel, block_res=16)
    assert len(verts) > 500 and len(faces) > 500
    r = np.linalg.norm(verts - center, axis=-1)
    assert abs(np.median(r) - radius) < 1.5 * voxel
    assert np.quantile(np.abs(r - radius), 0.9) < 3 * voxel
    np.testing.assert_allclose(np.median(vcol, axis=0), [0.8, 0.1, 0.2], atol=0.05)
    assert faces.min() >= 0 and faces.max() < len(verts)


def test_sparse_matches_dense_surface(sphere_views):
    """tests/test_tsdf.py:112 on the port."""
    _, tcams, depths, _, center, _ = sphere_views
    voxel = 0.025
    lo = np.array([-0.8, -0.8, -0.8], np.float32)
    t_d, w_d = ttsdf.fuse_depth_maps(depths, tcams, lo, voxel, (65, 65, 65), sdf_trunc=0.1,
                                     depth_min=0.3, depth_max=6.0)
    v_dense, _ = ttsdf.grid_to_mesh(t_d, w_d, lo, voxel)
    blocks = ttsdf.discover_blocks(depths, tcams, voxel, block_res=8, sdf_trunc=0.1,
                                   depth_min=0.3, depth_max=6.0)
    t_s, w_s, _ = ttsdf.fuse_blocks(depths, None, tcams, blocks, voxel, block_res=8,
                                    sdf_trunc=0.1, depth_min=0.3, depth_max=6.0, batch=128)
    v_sparse, _, _ = ttsdf.blocks_to_mesh(t_s, w_s, None, blocks, voxel, block_res=8)
    assert len(v_sparse) > 200
    from scipy.spatial import cKDTree

    d, _ = cKDTree(v_dense).query(v_sparse)
    assert np.quantile(d, 0.95) < voxel, np.quantile(d, 0.95)


# ---------------------------------------------------------------------------
# The CLI against gof_tpu's on the same PLY
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("tsdf_cli")
    scene = str(root / "scene")
    make_scene(scene, n_gaussians=16, n_views=8, size=64)
    out = str(root / "model")
    ttrain.main(["-s", scene, "-m", out, "--cpu", "--iterations", "5", "--sh_degree", "1",
                 "--kernel_size", "0.1", "--test_iterations", "99", "--quiet"])
    return out


def read_mesh(path):
    v, f = ply.read_ply(path)
    return np.stack([v["x"], v["y"], v["z"]], -1), f, v


@pytest.mark.parametrize("layout", [["--voxel_size", "0.02", "--sdf_trunc", "0.08",
                                     "--block_res", "8"],
                                    ["--dense", "--voxel_size", "0.05", "--sdf_trunc", "0.15",
                                     "--max_dim", "48"]], ids=["sparse", "dense"])
def test_extract_mesh_tsdf_cli_matches_gof_tpu(trained_model, tmp_path, layout):
    """extract_mesh_tsdf.main --cpu writes test/ours_5/tsdf/tsdf.ply from the
    port's renders; gof_tpu's CLI on a copy of the same model (its renders
    within the blend tolerance) gives a mesh whose every vertex lies within
    1e-3 of one of the port's, and the same counts within 2%."""
    copies = {}
    for name in ("port", "gof"):
        copies[name] = str(tmp_path / name)
        shutil.copytree(trained_model, copies[name])
    res = tcli.main(["-m", copies["port"], "--cpu", *layout])
    jcli.main(["-m", copies["gof"], "--cpu", *layout])
    rel = os.path.join("test", "ours_5", "tsdf", "tsdf.ply")
    assert res["path"] == os.path.join(copies["port"], rel)
    tv, tf, tprops = read_mesh(os.path.join(copies["port"], rel))
    jv, jf, jprops = read_mesh(os.path.join(copies["gof"], rel))
    assert res["verts"] == len(tv) > 100 and res["faces"] == len(tf) and res["views"] == 8
    assert set(res["seconds"]) >= {"render", "fuse", "mesh", "write"}
    assert list(tprops) == list(jprops)  # the same vertex properties (colors when sparse)
    assert abs(len(tv) - len(jv)) <= 0.02 * len(jv) and abs(len(tf) - len(jf)) <= 0.02 * len(jf)
    from scipy.spatial import cKDTree

    d, _ = cKDTree(tv).query(jv)
    assert np.quantile(d, 0.99) < 1e-3, np.quantile(d, 0.99)
    assert np.isfinite(tv).all() and tf.max() < len(tv)
