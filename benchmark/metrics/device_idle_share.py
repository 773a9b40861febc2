"""The device's idle share over the traced units (steps, views or calls):
1 - (the union of its operations' intervals) / the traced window's wall
time. One reader serves every suffix (.train, .render, .field)."""

def read(run):
    return 1.0 - run.trace.busy_s / run.trace.window_s
