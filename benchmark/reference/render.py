"""The plain reference's render, train steps and field evaluation, on the
tensors the generator made (benchmark/generate.py), in blocks of tiles so
that the dense blend fits on one card.

`dtype` is float32 for the reference and bfloat16 for the precision control
(the configurations state float32): the same code, one precision lower.
"""

from __future__ import annotations

import torch

from . import gof

# elements of one [tiles, rows, pixels] temporary of the dense blend
BLOCK = 1 << 25
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
# rows short of a bound at which a step's margin is read: the program's
# tile lists hold a few keys the reference's lack (~1e-4 of them) and may
# order gaussians of near-equal depth the other way, so its cut can stand a
# few rows apart from the reference's
TIE_ROWS = 2


def cast_model(model: dict, dtype) -> dict:
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in model.items()}


def view_rows(model: dict, view: gof.View, sh_degree: int, active_degree: int,
              kernel_size: float):
    """The blend rows [P, 16] of one view (differentiable in the model's
    leaves) and the depth-sorted tile lists."""
    op = gof.filtered_opacity(model["scaling"], model["opacity"], model["filter_3d"])
    pre = gof.preprocess(model["xyz"], gof.filtered_scaling(model["scaling"], model["filter_3d"]),
                         model["rotation"], gof.features(model, active_degree), sh_degree, view,
                         kernel_size, model["active"], opacities=op)
    ntx, nty = gof.tile_grid(view.width, view.height)
    with torch.no_grad():
        rects = gof.tile_rects(pre.mean2d, pre.radius_xy, pre.valid, ntx, nty)
        bins = gof.bin_tiles(pre.depth, rects, ntx, nty)
    return gof.rows_of(pre, op), bins


def to_tiles(img, ntx: int, nty: int):
    """[C, H, W] -> [NT, C, PIX] (pixels past the image's edge zero)."""
    C, H, W = img.shape
    full = img.new_zeros((C, nty * gof.TILE, ntx * gof.TILE))
    full[:, :H, :W] = img
    full = full.reshape(C, nty, gof.TILE, ntx, gof.TILE).permute(1, 3, 0, 2, 4)
    return full.reshape(nty * ntx, C, gof.TILE_PIXELS)


def render(rows, bins, view: gof.View, bg, tiles=None, block: int = BLOCK):
    """The [9, H, W] image (tiles not listed stay zero) and, per listed
    tile, its (visited, active) (pixel, row) pair counts [NT, PIX]."""
    ntx, nty = gof.tile_grid(view.width, view.height)
    dev = rows.device
    if tiles is None:
        tiles = torch.arange(ntx * nty, device=dev)
    outs, vis, act, order = [], [], [], []
    with torch.no_grad():
        for tl, chunk in gof.tile_blocks(bins, tiles, block):
            o, v, a = gof.render_block(rows, bins, tl, chunk, ntx, view, bg)
            outs.append(o)
            vis.append(v)
            act.append(a)
            order += tl
    t = torch.as_tensor(order, device=dev)
    img = gof.assemble(torch.cat(outs), t, ntx, nty, view.width, view.height)
    return img, t, torch.cat(vis), torch.cat(act)


def in_image(tiles, view: gof.View):
    """[NT, PIX] mask of the tiles' pixels that lie inside the image."""
    ntx, _ = gof.tile_grid(view.width, view.height)
    lane = torch.arange(gof.TILE_PIXELS, device=tiles.device)
    px = ((tiles % ntx) * gof.TILE)[:, None] + lane % gof.TILE
    py = ((tiles // ntx) * gof.TILE)[:, None] + lane // gof.TILE
    return (px < view.width) & (py < view.height)


def loss_and_backward(rows, bins, view: gof.View, bg, loss_fn, image, block: int = BLOCK):
    """loss_fn(image) and its gradient sent back to `rows`' graph. `image`
    is the view blended without a graph (render); the loss is
    differentiated at it, then each block of tiles is blended again with a
    graph and sent its share of the image's gradient, and the rows' summed
    gradient goes back through the preprocess at once."""
    image = image.detach().requires_grad_(True)
    loss = loss_fn(image)
    (g_img,) = torch.autograd.grad(loss, image)
    ntx, nty = gof.tile_grid(view.width, view.height)
    g_tiles = to_tiles(g_img, ntx, nty)
    leaf = rows.detach().requires_grad_(True)
    tiles = torch.arange(ntx * nty, device=rows.device)
    for tl, chunk in gof.tile_blocks(bins, tiles, block):
        out = gof.render_block(leaf, bins, tl, chunk, ntx, view, bg)[0]
        out.backward(g_tiles[torch.as_tensor(tl, device=rows.device)])
    rows.backward(leaf.grad)
    return loss.detach()


@torch.no_grad()
def transmittance_at(rows, bins, view: gof.View, bound, block: int = BLOCK) -> float:
    """The largest T of an in-image pixel of a tile that `bound` cuts
    (length > bound), after the bound's rows: above 1e-4, the tile was cut
    short of its need. 0.0 where no tile is cut."""
    cut = torch.nonzero(bins.length > bound).flatten()
    if len(cut) == 0:
        return 0.0
    ntx, _ = gof.tile_grid(view.width, view.height)
    head = gof.Bins(gid=bins.gid, start=bins.start, length=torch.minimum(bins.length, bound))
    worst = 0.0
    for tl, chunk in gof.tile_blocks(head, cut, block):
        T = gof.blend_tiles(rows, head, tl, chunk, ntx, view, stop=0.0)[0]
        t = torch.as_tensor(tl, device=rows.device)
        worst = max(worst, float(torch.where(in_image(t, view), T, 0.0).amax()))
    return worst


def fresh_start(model: dict, step: int) -> dict:
    """A training state at the model's own leaves with a fresh Adam state
    (zero moments, no update yet) at the step index `step`."""
    return {"params": {k: model[k] for k in LEAVES},
            "mu": {k: torch.zeros_like(model[k]) for k in LEAVES},
            "nu": {k: torch.zeros_like(model[k]) for k in LEAVES},
            "count": 0, "step": int(step)}


def train_steps(start: dict, model: dict, cams: list, gts, bounds, bg, opt: dict, train: dict,
                dtype, block: int = BLOCK, follow: list | None = None) -> dict:
    """GOF's training step with temporal liveness culling on each of `cams`
    in turn, from the training state `start` (params, Adam's moments mu and
    nu and its update count, the step index; see fresh_start) and the rest
    of `model` (filter_3d, active).

    bounds[j] ([NT] int, or None for no bound) is the number of rows kept
    at the head of each tile's depth-sorted list in step j. A tile's need is
    the number of rows met while some pixel of it inside the image has T
    above 1e-4 (every later row adds nothing). Where the bound cuts a tile
    short of its need, the view renders wrong and the step is skipped: no
    update, as gof_tpu's gate does. Otherwise the step renders the whole
    list and Adam updates every leaf (the position lr at the update count).
    With `follow` (a skip flag per step, the program's) the steps skip or
    run as it says, whatever the reference decides, so that one decision
    taken the other way at a tie of rounding does not part the states of
    the steps after it; the decision itself is judged by its margin.

    Per step: the tiles' need and length, the skip decision, its margin
    (the largest T of an in-image pixel of a tile cut TIE_ROWS rows short of
    the bound, after those rows, over 1e-4; 0 where no tile is cut) and the
    loss of a step that ran; each leaf's gradient norm at the first step that ran, and each
    leaf's change after the last; norms in float64. `train` holds
    sh_degree, kernel_size and spatial_lr_scale."""
    m = cast_model(model, dtype)
    dev = m["xyz"].device
    params = {k: start["params"][k].to(dev, dtype).clone().requires_grad_(True) for k in LEAVES}
    first = {k: params[k].detach().clone() for k in LEAVES}
    mu = {k: start["mu"][k].to(dev, dtype).clone() for k in LEAVES}
    nu = {k: start["nu"][k].to(dev, dtype).clone() for k in LEAVES}
    count = int(start["count"])
    steps, grad_norms = [], {}
    bg = bg.to(dtype)
    for j, (view, gt, bound) in enumerate(zip(cams, gts, bounds)):
        step = int(start["step"]) + j
        view = view.cast(dtype)
        active_degree = min(step // 1000, int(train["sh_degree"]))
        rows, bins = view_rows({**m, **params}, view, int(train["sh_degree"]), active_degree,
                               float(train["kernel_size"]))
        image, tiles, vis, _ = render(rows.detach(), bins, view, bg, block=block)
        need = torch.zeros_like(bins.length)
        need[tiles] = (vis * in_image(tiles, view)).amax(dim=1)
        skip, margin = False, 0.0
        if bound is not None:
            bound = bound.to(dev)
            skip = bool(((bins.length > bound) & (need > bound)).any())
            short = torch.clamp(bound - TIE_ROWS, min=0)
            margin = transmittance_at(rows.detach(), bins, view, short, block) / gof.TRANSMITTANCE_EPS
        rec = {"need": need.cpu(), "length": bins.length.cpu(), "skip": skip, "margin": margin,
               "loss": None}
        steps.append(rec)
        if (follow[j] if follow is not None else skip):
            continue
        rec["loss"] = float(loss_and_backward(
            rows, bins, view, bg, lambda img: gof.train_loss(img, gt.to(dtype), view, opt, step),
            image, block))
        lrs = gof.adam_lrs(opt, count, float(train["spatial_lr_scale"]))
        count += 1
        with torch.no_grad():
            for k in LEAVES:
                g = params[k].grad
                if k not in grad_norms:
                    grad_norms[k] = float(torch.linalg.norm(g.double()))
                upd, mu[k], nu[k] = gof.adam_leaf(g, mu[k], nu[k], lrs[k], count)
                params[k].add_(upd)
                params[k].grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.norm((params[k] - first[k]).double())) for k in LEAVES}
    return {"steps": steps, "grad": grad_norms, "change": change}


# --------------------------------------------------------------------------
# the opacity field at points (GOF's integrate: no early exit, the sample
# depth clamped to the point's)
# --------------------------------------------------------------------------

def _point_rays(points, view: gof.View):
    wv, fp = view.world_view, view.full_proj
    pv = points @ wv[:3, :3].T + wv[:3, 3]
    z = pv[:, 2]
    ok = z > 1e-4
    zs = torch.where(ok, z, torch.ones_like(z))
    ph = points @ fp[:3, :3].T + fp[:3, 3]
    pw = points @ fp[3, :3] + fp[3, 3]
    ndc = ph / (pw[:, None] + 1e-7)
    px = gof.ndc_to_pixel(ndc[:, 0], view.width)
    py = gof.ndc_to_pixel(ndc[:, 1], view.height)
    ok = ok & (px >= 0) & (px < view.width) & (py >= 0) & (py < view.height)
    return pv[:, 0] / zs, pv[:, 1] / zs, z, px, py, ok


def field_bins(model: dict, view: gof.View, kernel_size: float):
    """Per view: blend rows [P, 16] (colour unused) and tile lists, from the
    preprocess without opacities (3-sigma radii), as the field's is."""
    op = gof.filtered_opacity(model["scaling"], model["opacity"], model["filter_3d"])
    zero_sh = model["xyz"].new_zeros((model["xyz"].shape[0], 1, 3))
    pre = gof.preprocess(model["xyz"], gof.filtered_scaling(model["scaling"], model["filter_3d"]),
                         model["rotation"], zero_sh, 0, view, kernel_size, model["active"])
    ntx, nty = gof.tile_grid(view.width, view.height)
    rects = gof.tile_rects(pre.mean2d, pre.radius_xy, pre.valid, ntx, nty)
    return gof.rows_of(pre, op), gof.bin_tiles(pre.depth, rects, ntx, nty)


def point_tiles(points, view: gof.View):
    """Each point's tile (NT where it projects into no pixel) and its ray."""
    ntx, nty = gof.tile_grid(view.width, view.height)
    rx, ry, z, px, py, ok = _point_rays(points, view)
    tx = torch.clamp(px / gof.TILE, 0, ntx - 1).to(torch.int64)
    ty = torch.clamp(py / gof.TILE, 0, nty - 1).to(torch.int64)
    return torch.where(ok, ty * ntx + tx, ntx * nty), rx, ry, z


@torch.no_grad()
def view_transmittance(rows, bins, points, view: gof.View, block: int = BLOCK):
    """T of each point in one view: the product of (1 - alpha) over its
    tile's gaussians; 1 where the point projects into no pixel. Tiles go
    in blocks of [tiles, rows, points] at most `block` elements."""
    tile, rx, ry, z = point_tiles(points, view)
    dev, dt = rows.device, rows.dtype
    ntiles = bins.length.shape[0]
    T = torch.ones(points.shape[0], dtype=dt, device=dev)
    order = torch.argsort(tile, stable=True)
    counts = torch.bincount(tile, minlength=ntiles + 1)[:ntiles]
    pstart = torch.cumsum(counts, 0) - counts
    busy = torch.nonzero((counts > 0) & (bins.length > 0)).flatten()
    busy = busy[torch.argsort(bins.length[busy] * counts[busy], descending=True)]
    r_all = torch.stack([rx, ry, torch.ones_like(rx)], -1).to(dt)
    i, busy = 0, busy.tolist()
    while i < len(busy):
        L, n = int(bins.length[busy[i]]), int(counts[busy[i]])
        chunk = max(1, min(L, block // n))
        nt = max(1, block // (chunk * n))
        tl = torch.as_tensor(busy[i:i + nt], device=dev)
        i += nt
        npad = int(counts[tl].max())
        j = torch.arange(npad, device=dev)
        has = j[None, :] < counts[tl][:, None]
        pid = order[torch.where(has, pstart[tl][:, None] + j, torch.zeros_like(j))]  # [nt, N]
        r, zt = r_all[pid], z[pid].to(dt)
        acc = torch.ones(pid.shape, dtype=dt, device=dev)
        k = torch.arange(chunk, device=dev)
        for c0 in range(0, int(bins.length[tl].max()), chunk):
            inside = c0 + k[None, :] < bins.length[tl][:, None]
            key = torch.where(inside, bins.start[tl][:, None] + c0 + k, torch.zeros_like(k))
            p = rows[bins.gid[key]] * inside[..., None]  # [nt, L, 16]
            M, u0, op = p[..., 4:13].reshape(*p.shape[:2], 3, 3), p[..., 13:16], p[..., 3:4]
            d = torch.einsum("tlij,tnj->tlni", M, r)
            dd = (d * d).sum(-1) + 1e-12
            tpk = -torch.einsum("tli,tlni->tln", u0, d) / dd
            ts = torch.minimum(tpk, zt[:, None, :])
            v = u0[:, :, None, :] + ts[..., None] * d
            a = torch.clamp_max(op * torch.exp(-0.5 * (v * v).sum(-1)), gof.ALPHA_MAX)
            a = torch.where((tpk > gof.NEAR_PLANE) & (a >= gof.ALPHA_MIN), a, torch.zeros_like(a))
            acc = acc * torch.prod(1.0 - a, dim=1)
        T[pid[has]] = acc[has]
    return T


@torch.no_grad()
def field_alpha(model: dict, cams: list, points, kernel_size: float, dtype,
                block: int = BLOCK):
    """GOF's field at `points`: 1 - min over views of (1 - T_view)."""
    m = cast_model(model, dtype)
    pts = points.to(dtype)
    final = torch.ones(pts.shape[0], dtype=dtype, device=pts.device)
    for view in cams:
        view = view.cast(dtype)
        rows, bins = field_bins(m, view, kernel_size)
        final = torch.minimum(final, 1.0 - view_transmittance(rows, bins, pts, view, block))
    return 1.0 - final
