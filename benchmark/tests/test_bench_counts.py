"""The frozen counts against hand-worked counts on tiny shapes, and the
benchmark's pair counting against a brute-force walk."""

from __future__ import annotations

import pytest
import torch

from benchmark import generate
from benchmark.counts import blend, integrate, peaks, step
from benchmark.entries import field as field_entry
from benchmark.entries import train as train_entry
from benchmark.reference import gof
from benchmark.reference import render as ref

from conftest import tiny_cell


def test_blend_counts_by_hand():
    # 10 visited pairs, 4 active, 3 walked rows, 2 pixels, 1 tile
    assert blend.k1(10, 4, 3, 2, 1, False) == {
        "ops": 10 * 41 + 4 * 11, "bytes": 4 * (3 * 16 + 2 + 2 * 9 + 2 * 3)}
    assert blend.k1(10, 4, 3, 2, 1, True)["ops"] == 10 * 41 + 4 * (11 + 39)
    assert blend.k3(10, 4, 3, 2, True, False) == {
        "ops": 10 * 41 + 4 * (53 + 81), "bytes": 4 * (3 * 16 + 2 * 21 + 3 * 17)}
    assert blend.k3(10, 4, 3, 2, False, True)["ops"] == 10 * 41 + 4 * (53 + 23)
    assert blend.k4(3, 2) == {"ops": 48, "bytes": 4 * (3 * 17 + 2 * 16)}


def test_integrate_and_step_counts_by_hand():
    assert integrate.k5(7, 5, 3, 2) == {"ops": 7 * 45, "bytes": 4 * (5 * 16 + 3 + 3 * 5)}
    assert step.ops(2, 3, 100, 200, 10) == 2 * (610 + 1220 + 14 * 59) + 3 * 2400 + 310
    assert step.ops(2, 3, 100, 200, 10, backward=False) == 2 * 610 + 3 * 800 + 100


def test_peaks_share():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.share(67e12, 0, 2.0) == pytest.approx(50.0)
    assert peaks.share(1, 1, None) is None


def _walk_counts(rows, bins, view, tiles):
    """Brute force: per in-image pixel, walk its tile's rows in order while
    T > 1e-4; count the rows met and those whose alpha passes."""
    ntx, _ = gof.tile_grid(view.width, view.height)
    vis = act = 0
    for t in tiles.tolist():
        rx, ry = gof.tile_rays(torch.tensor([t]), ntx, view, torch.float32)
        keys = bins.start[t] + torch.arange(int(bins.length[t]))
        p = rows[bins.gid[keys]][None]
        a = gof.ray_terms(p, rx, ry)[0][0]  # [L, PIX]
        real = ref.in_image(torch.tensor([t]), view)[0]
        for pix in torch.nonzero(real).flatten().tolist():
            T = 1.0
            for k in range(a.shape[0]):
                if T <= gof.TRANSMITTANCE_EPS:
                    break
                vis += 1
                act += int(a[k, pix] > 0)
                T *= 1.0 - float(a[k, pix])
    return vis, act


def test_blend_pairs_match_a_brute_force_walk():
    cell = tiny_cell("bicycle-train-late", gaussians=120, width=40, height=36)
    dev = torch.device("cpu")
    model = generate.gaussians(cell.config, 3, dev)
    view = generate.views(cell.config["cameras"], dev)[1]
    tc = {**cell.config["train"], "step": 20000}
    got = train_entry.view_pairs(model, view, torch.zeros(3), tc)
    rows, bins = ref.view_rows(model, view, 3, 3, float(tc["kernel_size"]))
    ntx, nty = gof.tile_grid(view.width, view.height)
    vis, act = _walk_counts(rows.detach(), bins, view, torch.arange(ntx * nty))
    assert got["visited"] == vis and got["active"] == act
    assert got["pixels"] == 40 * 36 and got["tiles"] == ntx * nty
    assert 0 < got["rows"] <= int(bins.length.sum())


def test_field_pairs_by_hand():
    cell = tiny_cell("dtu-field", gaussians=80)
    dev = torch.device("cpu")
    model = generate.gaussians(cell.config, 4, dev)
    view = generate.views(cell.config["cameras"], dev)[0]
    pts = generate.tetra_points(model, [view])
    got = field_entry.view_pairs(model, view, pts, 0.0)
    _, bins = ref.field_bins(model, view, 0.0)
    tile = ref.point_tiles(pts, view)[0]
    pairs = sum(int(bins.length[t]) for t in tile.tolist() if t < bins.length.shape[0])
    assert got["ops"] == 45 * pairs
