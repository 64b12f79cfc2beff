"""The matcher call's share of the chip's peak: the model's products that
the inputs of every call of the measured window need (benchlib/work.py:
keypoint encoder, every layer's projections, attention over valid pairs,
merge and MLP, the score head; EIMP at its buckets, with a head every
iteration) over the window's host-clock time, against the peak for the
configuration's dtype (benchlib/peaks.py), in %."""
from benchlib import peaks, work


def read(view):
    m = view.config["matcher"]
    every = view.config["model"] == "AdaGMN"
    flops = sum(work.forward_flops(m, a, b, every)
                for n0, n1 in view.window_counts for a, b in zip(n0, n1))
    if not flops or view.window_s <= 0:
        return None
    return 100.0 * flops / view.window_s / peaks.peak_flops(m["compute_dtype"])
