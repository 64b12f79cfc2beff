"""The device's idle share at the untraced rate of the matcher calls: 1 minus the device's
busy time a call (the union of the device operations' intervals over one
traced turn of the pool, device activity alone) over the measured window's
mean call (host clock, no profiler), in %. The profiler's own cost per
launch, which lengthens a traced call, stays out of it."""


def read(view):
    t = view.trace
    if not t.calls or not view.window_counts or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.calls) / (view.window_s / len(view.window_counts)))
