"""The share of the untraced window's steps skipped because a liveness
bound proved stale (the program's skip flag)."""

def read(run):
    c = run.runner.counters("window")
    return float(c[:, 9].mean()) if len(c) else None
