"""Marching tetrahedra, binary-search-ready (counterpart of
gof_tpu/mesh/tetmesh.py).

Like the reference it returns the crossing-edge ENDPOINTS with their field
values and scales rather than interpolated vertices: the binary-search
refinement needs the interval. The 16-case table is derived in code: 1-vs-3
splits give one triangle from the lone vertex's three crossing edges,
2-vs-2 splits a quad (two triangles) over the four crossing edges.

Two paths with the same edge list and the same face set:
- `_marching_tetrahedra_np`, host numpy: the path for numpy inputs (the
  CPU extraction);
- `_marching_tetrahedra_torch`, torch ops on the sdf's device: the path for
  tensor inputs (the CUDA extraction). The edge dedup is one stable
  `torch.sort` of the int64 key `vmin * N + vmax`, which orders the edges as
  gof_tpu's two-key (vmin, vmax) sort does; faces come out in tet order
  rather than case order. Only the compacted results move to the host.
"""

from __future__ import annotations

import numpy as np
import torch

# tet edge slots: pairs of local vertex indices
EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int32)
_EDGE_SLOT = {(i, j): k for k, (i, j) in enumerate(EDGES)}


def _slot(i, j):
    return _EDGE_SLOT[(min(i, j), max(i, j))]


def _build_case_table():
    """For each of 16 sign configs, the triangles as triples of edge slots."""
    table = []
    for case in range(16):
        pos = [v for v in range(4) if case & (1 << v)]
        neg = [v for v in range(4) if not case & (1 << v)]
        tris = []
        if len(pos) == 1 or len(neg) == 1:
            lone = pos[0] if len(pos) == 1 else neg[0]
            others = [v for v in range(4) if v != lone]
            tris.append([_slot(lone, others[0]), _slot(lone, others[1]), _slot(lone, others[2])])
        elif len(pos) == 2:
            a, b = pos
            c, d = neg
            e_ac, e_ad, e_bd, e_bc = _slot(a, c), _slot(a, d), _slot(b, d), _slot(b, c)
            tris.append([e_ac, e_ad, e_bd])
            tris.append([e_ac, e_bd, e_bc])
        table.append(np.array(tris, np.int32).reshape(-1, 3))
    return table


CASE_TABLE = _build_case_table()


def _padded_table():
    """[16, 2, 3] case table padded with -1 (cases emit 0, 1 or 2 triangles)."""
    t = np.full((16, 2, 3), -1, np.int32)
    for case, tris in enumerate(CASE_TABLE):
        for i, tri in enumerate(tris):
            t[case, i] = tri
    return t


PADDED_TABLE = _padded_table()


def _empty_result():
    return {
        "edge_points": np.zeros((0, 2, 3), np.float32),
        "edge_sdf": np.zeros((0, 2), np.float32),
        "edge_scale": np.zeros((0, 2), np.float32),
        "edge_verts": np.zeros((0, 2), np.int64),
        "faces": np.zeros((0, 3), np.int64),
    }


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _edge_arrays(vertices, sdf, scales, pairs: np.ndarray, faces: np.ndarray):
    vertices, sdf = _host(vertices), _host(sdf)
    edge_sdf = sdf[pairs]
    edge_scale = _host(scales)[pairs] if scales is not None else np.zeros_like(edge_sdf)
    return {
        "edge_points": vertices[pairs].astype(np.float32),
        "edge_sdf": edge_sdf.astype(np.float32),
        "edge_scale": edge_scale.astype(np.float32),
        "edge_verts": pairs.astype(np.int64),
        "faces": faces.astype(np.int64),
    }


def marching_tetrahedra(vertices, tets, sdf, scales=None):
    """Extract the sdf=0 crossing structure from a tet mesh.

    Args:
      vertices: [N, 3]; tets: [T, 4] int; sdf: [N]; scales: [N] per-vertex
        scale hints (the reference's points_scale, used for face filtering).
        A torch tensor `sdf` selects the torch path on its device (tets may
        be numpy or a tensor); numpy inputs take the numpy path.

    Returns a dict of numpy arrays:
      edge_points: [E, 2, 3] crossing-edge endpoint coordinates
      edge_sdf:    [E, 2]
      edge_scale:  [E, 2] (zeros if scales is None)
      edge_verts:  [E, 2] int endpoint indices into `vertices`, in
                   (vmin, vmax) lexicographic order
      faces:       [F, 3] int indices into the E edges
    """
    if isinstance(sdf, torch.Tensor):
        return _marching_tetrahedra_torch(vertices, tets, sdf, scales)
    return _marching_tetrahedra_np(vertices, tets, sdf, scales)


def _marching_tetrahedra_torch(vertices, tets, sdf: torch.Tensor, scales=None):
    """Marching tets in torch ops on sdf's device: everything but the final
    compacted transfers runs there. Same edge list as the numpy path; the
    same faces up to row order."""
    dev = sdf.device
    n_verts = sdf.shape[0]
    tets_d = torch.as_tensor(tets, device=dev).to(torch.int64)
    sign = (sdf > 0).to(torch.int64)
    occ = (sign[tets_d[:, 0]] | (sign[tets_d[:, 1]] << 1)
           | (sign[tets_d[:, 2]] << 2) | (sign[tets_d[:, 3]] << 3))
    crossing = (occ != 0) & (occ != 15)
    rows = torch.nonzero(crossing).squeeze(1)  # ascending tet order
    nc = rows.shape[0]
    if nc == 0:
        return _empty_result()
    tets_c = tets_d[rows]
    occ_c = occ[rows]

    # edge dedup: one stable sort of the 6 * nc keys vmin * N + vmax
    ev = torch.sort(tets_c[:, torch.as_tensor(EDGES, device=dev).long()], dim=-1).values
    key = (ev[..., 0] * n_verts + ev[..., 1]).reshape(-1)  # [6 nc]
    skey, sidx = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    gid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
    edge_id = torch.empty_like(gid_sorted)
    edge_id[sidx] = gid_sorted
    edge_id = edge_id.reshape(nc, 6)
    ukey = skey[first]  # [E] in (vmin, vmax) order
    pairs = torch.stack([ukey // n_verts, ukey % n_verts], dim=-1)

    # faces: case-table lookup, 1 or 2 triangles per crossing tet, tet order
    slots = torch.as_tensor(PADDED_TABLE, device=dev).long()[occ_c]  # [nc, 2, 3]
    valid = slots[:, :, 0] >= 0
    f = torch.gather(edge_id[:, None, :].expand(nc, 2, 6), 2, torch.clamp(slots, 0, 5))
    faces = f.reshape(-1, 3)[valid.reshape(-1)]

    # keep only edges referenced by faces, remap to compact ids
    used = torch.zeros(pairs.shape[0], dtype=torch.bool, device=dev)
    used[faces.reshape(-1)] = True
    remap = torch.cumsum(used.to(torch.int64), 0) - 1
    return _edge_arrays(vertices, sdf, scales, _host(pairs[used]), _host(remap[faces]))


def _marching_tetrahedra_np(vertices, tets, sdf, scales=None):
    sdf = np.asarray(sdf)
    tets = np.asarray(tets)
    sign = sdf > 0
    occ = (
        sign[tets[:, 0]].astype(np.int32)
        | (sign[tets[:, 1]] << 1)
        | (sign[tets[:, 2]] << 2)
        | (sign[tets[:, 3]] << 3)
    )
    crossing = (occ != 0) & (occ != 15)
    tets_c = tets[crossing]
    occ_c = occ[crossing]
    if len(tets_c) == 0:
        return _empty_result()

    # global ids for all 6 edges of crossing tets
    ev = np.sort(tets_c[:, EDGES], axis=-1)  # [Tc, 6, 2] vertex pairs
    uniq, inv = np.unique(ev.reshape(-1, 2), axis=0, return_inverse=True)
    edge_id = inv.reshape(len(tets_c), 6)  # [Tc, 6] -> global edge

    faces = []
    for case in range(1, 15):
        rows = np.nonzero(occ_c == case)[0]
        if len(rows) == 0:
            continue
        for tri in CASE_TABLE[case]:
            faces.append(edge_id[rows][:, tri])
    faces = np.concatenate(faces, axis=0).astype(np.int64)

    # keep only edges actually used by faces, remap indices
    used, faces_r = np.unique(faces.reshape(-1), return_inverse=True)
    return _edge_arrays(vertices, sdf, scales, uniq[used], faces_r.reshape(-1, 3))
