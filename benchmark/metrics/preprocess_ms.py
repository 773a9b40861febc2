"""The preprocess's device ms a step or view (`preprocess` spans: the
filtered scales, opacities and SH features, then quadrics.preprocess, the
tile rects and the effective opacity; forward only, its backward runs in
`backward`). One reader serves .train and .render."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["preprocess"])
