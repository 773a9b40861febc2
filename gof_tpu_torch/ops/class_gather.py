"""Class-expansion gather (counterpart of gof_tpu/ops/class_gather.py).

bin_gaussians resolves every duplicated-key slot to its owning gaussian's
attributes with one [CAP]-wide gather `tbl[:, gidx]` of int32 columns (rect,
depth bits, count, id and the cull columns), where `gidx` is monotone with
steps of 0 or 1. On CUDA tensors this is kernel csrc/expand.cu; on CPU
tensors its plain version `expand_reference`. The TPU kernel's byte-plane
indicator matmul has no purpose on a GPU: the gather is a plain bit copy.
"""

from __future__ import annotations

import torch

from . import cuda_lib

EXPAND = cuda_lib.LaunchCounter("expand")


def expand_reference(tbl: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Plain version: [ncols, P] int32, [CAP] int32 -> [ncols, CAP] int32."""
    return tbl[:, gidx.long()]


def expand_kernel_call(tbl: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """out[c, k] = tbl[c, gidx[k]], bit-exact, for gidx in [0, P).

    CPU tensors take `expand_reference`; CUDA tensors launch the kernel
    (csrc/expand.cu) or raise.
    """
    if tbl.device.type == "cpu" and gidx.device.type == "cpu":
        return expand_reference(tbl, gidx)
    cuda_lib.require(tbl.is_cuda and gidx.device == tbl.device,
                     f"expand: tensors on {tbl.device} and {gidx.device}")
    cuda_lib.require(tbl.dtype == torch.int32 and gidx.dtype == torch.int32,
                     f"expand: dtypes {tbl.dtype}, {gidx.dtype} (need int32)")
    cuda_lib.require(tbl.dim() == 2 and gidx.dim() == 1, "expand: tbl [ncols, P], gidx [CAP]")
    cuda_lib.require(tbl.is_contiguous() and gidx.is_contiguous(), "expand: non-contiguous input")
    ncols, P = tbl.shape
    cap = gidx.shape[0]
    out = torch.empty((ncols, cap), dtype=torch.int32, device=tbl.device)
    rc = cuda_lib.library().gof_expand(
        tbl.device.index, tbl.data_ptr(), ncols, P, gidx.data_ptr(), cap, out.data_ptr(),
        cuda_lib.stream_ptr(tbl))
    cuda_lib.check(rc, "expand")
    EXPAND.launches += 1
    return out


def expand(cols, gidx: torch.Tensor, P: int):
    """Resolve per-slot attrs: [v[clip(gidx)] for v in cols], bit-exact.

    cols: list of [P] int32 columns. (gof_tpu passes (values, nbytes) pairs:
    the byte counts sized its kernel's byte planes and have no use here.)
    """
    gidx = torch.clamp(gidx, 0, max(P - 1, 0)).to(torch.int32).contiguous()
    tbl = torch.stack([v.to(torch.int32) for v in cols], dim=0).contiguous()
    out = expand_kernel_call(tbl, gidx)
    return [out[i] for i in range(len(cols))]
