"""The payload gather's device ms a step or view (`payload` span:
rasterize.build_payload16). One reader serves .train and .render."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["payload"])
