"""The model side of a field view, device ms a view: the `preprocess`,
`binning` and `payload` spans of each `field_view` (FieldEvaluator.
view_inputs), which no call's points change."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["preprocess", "binning", "payload"])
