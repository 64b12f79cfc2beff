"""Device operations (kernels, copies, sets) in the trace, a matcher call."""


def read(view):
    t = view.trace
    return len(t.device_ops) / t.calls if t.calls else None
