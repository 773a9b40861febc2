"""Convert the official torch VGG16 and LPIPS checkpoints to the .npz that
gof_tpu_torch.metrics reads (the port of scripts/convert_lpips_weights.py).

Run offline, where the checkpoints are:

    python -m gof_tpu_torch.scripts.convert_lpips_weights \\
        --vgg vgg16-397923af.pth --lpips vgg.pth --out lpips_vgg16.npz

then pass --lpips_weights lpips_vgg16.npz to gof_tpu_torch.metrics (or set
GOF_LPIPS_WEIGHTS). The .npz holds torchvision's `features.*` conv weights
(OIHW) and the LPIPS heads' `lin*` weights, as gof_tpu's converter writes
it.
"""

from __future__ import annotations

import argparse
import hashlib

import numpy as np
import torch

# torchvision checkpoints embed the first 8 hex digits of their sha256 in the
# file name; the official vgg16's is pinned, so a wrong or corrupted download
# fails before it skews every LPIPS number
VGG16_SHA256_PREFIX = "397923af"


def check_vgg(path: str, skip: bool) -> None:
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest[:8] != VGG16_SHA256_PREFIX:
        msg = (f"{path}: sha256 {digest[:8]}... != expected torchvision vgg16 prefix "
               f"{VGG16_SHA256_PREFIX} (vgg16-397923af.pth)")
        if skip:
            print(f"WARNING: {msg}")
        else:
            raise SystemExit(msg)


def convert_torch_weights(vgg_pth: str, lpips_pth: str, out_npz: str) -> None:
    """The VGG16 state dict's `features.*` tensors and the LPIPS state dict's
    `lin*` tensors, as numpy arrays, into one .npz."""
    vgg = torch.load(vgg_pth, map_location="cpu")
    lin = torch.load(lpips_pth, map_location="cpu")
    out = {k: v.numpy() for k, v in vgg.items() if k.startswith("features.")}
    out.update({k: v.numpy() for k, v in lin.items() if k.startswith("lin")})
    np.savez(out_npz, **out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vgg", required=True, help="torchvision vgg16 state_dict (.pth)")
    ap.add_argument("--lpips", required=True, help="LPIPS vgg linear-head state_dict (.pth)")
    ap.add_argument("--out", required=True, help="output .npz")
    ap.add_argument("--skip_hash_check", action="store_true")
    args = ap.parse_args(argv)
    check_vgg(args.vgg, args.skip_hash_check)
    convert_torch_weights(args.vgg, args.lpips, args.out)
    print(f"wrote {args.out} (set GOF_LPIPS_WEIGHTS={args.out} or pass --lpips_weights to "
          f"gof_tpu_torch.metrics)")


if __name__ == "__main__":
    main()
