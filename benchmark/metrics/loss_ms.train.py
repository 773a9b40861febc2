"""The loss's device ms a step (`loss` span: train_loss's L1, SSIM,
distortion and depth-normal terms, the PSNR, the terms' stack; forward
only)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["loss"])
