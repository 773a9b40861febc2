"""The quadric chain's device ms a step (`chain` span:
rasterize.quadric_chain, in float64); skipped steps count 0."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["chain"])
