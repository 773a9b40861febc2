"""The host's ms a field view (`field_view` spans, host clock): the
dispatch and the syncs of one view of the call."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, lambda n: n == "field_view")
