"""The host's ms a step or view inside the program's host syncs (`read.*`
spans: device-to-host reads; `copy.*`: host-to-device copies, each a
stream synchronisation on the card). One reader serves .train, .render
and .field (per view of each call)."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, lambda n: n.startswith(("read.", "copy.")))
