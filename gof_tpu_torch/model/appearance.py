"""Decoupled appearance network (counterpart of gof_tpu/model/appearance.py).

A per-view 64-d embedding (2048 slots) and a CNN that maps the
x32-downsampled render + embedding to a full-resolution RGB multiplier:
conv(3+64 -> 256) -> 4x [pixel-shuffle x2 + conv + relu] -> bilinear x2 ->
conv 16 -> conv 3 -> sigmoid. The port runs NCHW; gof_tpu's flax weights
carry across by name (`app_from_numpy` / `app_to_numpy`: HWIO kernels <->
OIHW weights). The align-corners resizes use gof_tpu's own
grid arithmetic, not F.interpolate's, so both packages sample at the same
float positions. The convs' weight and bias gradients sum over the pixels
in float64 (`Conv3x3`); everything else is float32, as in gof_tpu.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NUM_APPEARANCE_EMBEDDINGS = 2048
APPEARANCE_DIM = 64

# gof_tpu's flax module path of each conv -> the port's parameter prefix
FLAX_CONVS = {
    ("Conv_0",): "conv_in",
    ("UpsampleBlock_0", "Conv_0"): "up.0.conv",
    ("UpsampleBlock_1", "Conv_0"): "up.1.conv",
    ("UpsampleBlock_2", "Conv_0"): "up.2.conv",
    ("UpsampleBlock_3", "Conv_0"): "up.3.conv",
    ("Conv_1",): "conv_mid",
    ("Conv_2",): "conv_out",
}


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[N, C*r^2, H, W] -> [N, C, H*r, W*r] (gof_tpu's pixel_shuffle on
    NCHW: torch's channel blocks [C, r, r])."""
    return F.pixel_shuffle(x, factor)


def _align_corners_grid(out: int, size: int, device) -> torch.Tensor:
    """gof_tpu's sample positions: i * (size - 1) / (out - 1) in f32, all 0
    for a one-sample output. Computed on the host: CUDA rounds a division by
    a Python number as a product with its reciprocal, and one ulp in every
    position shifts the gradients of the first layers coherently."""
    if out == 1:
        return torch.zeros((out,), dtype=torch.float32, device=device)
    return (torch.arange(out, dtype=torch.float32) * (size - 1) / (out - 1)).to(device)


def _bilinear(x: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of [N, C, H, W] at rows gy and columns gx, with
    gof_tpu's corner order and weight products."""
    h, w = x.shape[-2:]
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    wy = (gy - y0)[:, None]
    wx = (gx - x0)[None, :]
    a = x[:, :, y0][:, :, :, x0]
    b = x[:, :, y0][:, :, :, x1]
    c = x[:, :, y1][:, :, :, x0]
    d = x[:, :, y1][:, :, :, x1]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx


def bilinear_x2_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample with align_corners=True on [N, C, H, W]. A size-1
    axis samples its one row (gof_tpu tests the input size there, the
    resize below the output size; the grids agree)."""
    h, w = x.shape[-2:]
    return _bilinear(x, _align_corners_grid(2 * h, h, x.device),
                     _align_corners_grid(2 * w, w, x.device))


def bilinear_resize_align_corners(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of [C, H, W]."""
    h, w = img.shape[-2:]
    return _bilinear(img[None], _align_corners_grid(out_h, h, img.device),
                     _align_corners_grid(out_w, w, img.device))[0]


class _Conv3x3(torch.autograd.Function):
    """A 3x3 conv with padding 1 whose weight and bias gradients sum in
    float64. Each sums over every pixel (~1M at full width), and a float32
    sum that long drifts from the exact value by up to ~1e-4 of its max
    with the trained state's cancellation; a product of two float32 values
    is exact in float64, so these sums round once, at the end. The forward
    and the input gradient (27-144 terms each) stay float32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        gx = (torch.nn.grad.conv2d_input(x.shape, weight, grad, padding=1)
              if ctx.needs_input_grad[0] else None)
        g64 = grad.double()
        gw = torch.nn.grad.conv2d_weight(x.double(), weight.shape, g64, padding=1)
        return gx, gw.to(weight.dtype), g64.sum((0, 2, 3)).to(weight.dtype)


class Conv3x3(nn.Conv2d):
    """nn.Conv2d(in, out, 3, padding=1) through _Conv3x3 (same parameters
    and names)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return _Conv3x3.apply(x, self.weight, self.bias)


class UpsampleBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels // 4, out_channels)

    def forward(self, x):
        return F.relu(self.conv(pixel_shuffle(x, 2)))


class AppearanceNetwork(nn.Module):
    """Input [N, 3+64, H/32, W/32] -> per-pixel RGB multiplier [N, 3, H, W]."""

    def __init__(self):
        super().__init__()
        self.conv_in = Conv3x3(3 + APPEARANCE_DIM, 256)
        self.up = nn.ModuleList([UpsampleBlock(256, 128), UpsampleBlock(128, 64),
                                 UpsampleBlock(64, 32), UpsampleBlock(32, 16)])
        self.conv_mid = Conv3x3(16, 16)
        self.conv_out = Conv3x3(16, 3)

    def forward(self, x):
        x = F.relu(self.conv_in(x))
        for block in self.up:
            x = block(x)
        x = bilinear_x2_align_corners(x)
        x = F.relu(self.conv_mid(x))
        return torch.sigmoid(self.conv_out(x))


def init_appearance(generator: torch.Generator, device: torch.device | str = "cpu"):
    """Returns (network, embeddings [2048, 64]), drawn from `generator` (a
    CPU generator, so every device starts from the same weights): flax's
    default conv init (lecun normal, truncated at 2 sigma; zero bias) and
    embeddings N(0, 1) * 1e-4 (scene/gaussian_model.py:114-116), so early
    appearance output starts near-neutral."""
    net = AppearanceNetwork()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
                # flax's truncated normal rescales its stddev to keep the variance
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.bias.zero_()
    emb = torch.randn((NUM_APPEARANCE_EMBEDDINGS, APPEARANCE_DIM), generator=generator) * 1e-4
    return net.to(device), emb.to(device)


def net_state_from_flax(tree) -> dict:
    """gof_tpu's flax tree ({"params": {module: {"kernel", "bias"}}}) or a
    moment tree of the same shape -> {port parameter name: tensor}, HWIO
    kernels as OIHW weights. Every conv must be present, and nothing else."""
    params = tree["params"]
    out = {}
    for path, name in FLAX_CONVS.items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaf["kernel"], np.float32).transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    if set(params) != {path[0] for path in FLAX_CONVS}:
        raise ValueError(f"unexpected appearance modules {sorted(params)}")
    return out


def net_state_to_flax(state: dict) -> dict:
    """The inverse of net_state_from_flax: numpy arrays in gof_tpu's tree."""
    params = {}
    for path, name in FLAX_CONVS.items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        w = state[f"{name}.weight"].detach().cpu().numpy()
        node[path[-1]] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                          "bias": state[f"{name}.bias"].detach().cpu().numpy()}
    return {"params": params}


def app_from_numpy(flax_params, emb, device: torch.device | str = "cpu"):
    """gof_tpu's (flax params, embeddings) -> (AppearanceNetwork, [2048, 64]
    tensor) on `device`, bit for bit."""
    net = AppearanceNetwork()
    net.load_state_dict(net_state_from_flax(flax_params))
    return net.to(device), torch.tensor(np.asarray(emb, np.float32), device=device)


def app_to_numpy(net: AppearanceNetwork, emb: torch.Tensor):
    """The inverse of app_from_numpy: (flax params tree, embeddings) as numpy."""
    return net_state_to_flax(dict(net.named_parameters())), emb.detach().cpu().numpy()


def center_crop_32(image: torch.Tensor) -> torch.Tensor:
    """The 32-aligned center crop of [C, H, W] (H and W rounded down to
    multiples of 32)."""
    _, origH, origW = image.shape
    H = origH // 32 * 32
    W = origW // 32 * 32
    top = origH // 2 - H // 2
    left = origW // 2 - W // 2
    return image[:, top:top + H, left:left + W]


def appearance_multiplier(crop, net: AppearanceNetwork, embeddings, view_idx: int):
    """The network's [3, H, W] RGB multiplier for a 32-aligned crop: its
    x32 downsample beside the view's embedding row, through the CNN."""
    _, H, W = crop.shape
    down = bilinear_resize_align_corners(crop, H // 32, W // 32)
    emb = embeddings[view_idx]
    emb_map = emb[:, None, None].expand(emb.shape[0], H // 32, W // 32)
    return net(torch.cat([down, emb_map], dim=0)[None])[0]


def appearance_l1(image, gt, net: AppearanceNetwork, embeddings, view_idx: int,
                  return_transformed: bool = False):
    """L1 on the appearance-transformed render (L1_loss_appearance,
    train.py:67-88): 32-aligned center crop, x32 downsample, CNN multiplier.
    image, gt: [3, H, W]; view_idx: the embedding row (camera.uid)."""
    crop = center_crop_32(image)
    transformed = appearance_multiplier(crop, net, embeddings, view_idx) * crop
    if return_transformed:
        return bilinear_resize_align_corners(transformed, *image.shape[1:])
    return torch.mean(torch.abs(transformed - center_crop_32(gt)))
