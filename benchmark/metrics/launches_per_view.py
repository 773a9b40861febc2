"""Device operations the traced units launched, per view rendered or
evaluated: the host's dispatch load. One reader serves every suffix
(.render: a view a unit; .field: every view of the configuration a call)."""

def read(run):
    return run.trace.launches / (run.trace.units * run.runner.views_per_unit)
