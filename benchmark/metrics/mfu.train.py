"""The training step's share of the chip's peak: the forward's products with
a score head every iteration (benchlib/work.py), and the backward at twice
the forward's, for every step of the measured window over the window's
host-clock time, against the peak for the configuration's dtype, in %."""
from benchlib import peaks, work


def read(view):
    m = view.config["matcher"]
    flops = 3.0 * sum(work.forward_flops(m, a, b, True)
                      for n0, n1 in view.window_counts for a, b in zip(n0, n1))
    if not flops or view.window_s <= 0:
        return None
    return 100.0 * flops / view.window_s / peaks.peak_flops(m["compute_dtype"])
