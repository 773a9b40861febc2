"""Device operations (kernels, copies, sets) the traced steps launched, per
step: the host's dispatch load."""

def read(run):
    return run.trace.launches / run.trace.units
