"""Adam's device ms a step (`adam` span: train.Adam.update, the in-place
adds of the updates, the appearance leaves' step); skipped steps count
0."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["adam"])
