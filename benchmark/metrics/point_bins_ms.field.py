"""Point binning's device ms a view (`point_bins` span:
integrate.bin_points, its read of the point slots included)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, ["point_bins"])
