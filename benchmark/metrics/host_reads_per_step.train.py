"""Device-to-host reads a step (`read.*` spans): the slot demand, the live
demand and live_bad on every step; on a step that runs its backward also
the compact demand and torch.prod's two zero counts (the filtered
opacity's backward)."""

from benchmark import spans


def read(run):
    return spans.count(run, lambda n: n.startswith("read."))
