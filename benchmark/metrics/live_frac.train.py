"""The share of a step's keys that liveness culling keeps (the program's
live_demand over num_keys), the mean over the untraced window's steps."""

def read(run):
    c = run.runner.counters("window")
    return float((c[:, 7] / c[:, 2].clamp_min(1)).mean()) if len(c) else None
