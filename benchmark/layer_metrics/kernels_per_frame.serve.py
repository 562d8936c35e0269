"""Device operations (kernels, copies, sets) in the traced window per frame
served: the two drones' three rounds each, with their uploads and
device→host copies."""


def read(r):
    return len(r.trace.device) / r.trace.units if r.trace.device else None
