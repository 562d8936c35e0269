"""Device operations (kernels, copies, sets) in the traced window, per
training step."""


def read(r):
    return len(r.trace.device) / r.trace.units if r.trace.device else None
