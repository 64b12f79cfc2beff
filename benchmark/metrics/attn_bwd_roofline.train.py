"""The attention backward's share of its roofline (kernel 3,
impx_torch/csrc/attention_bwd.cu, the backward that recomputes the
softmax): the least time of its five products over the valid (query, key)
pairs and of q, k, v, dO read and dq, dk, dv written (benchlib/work.py), at
the peaks for the configuration's dtype, over the device time of the
kernels whose names start with `bwd_dq_recompute` or `bwd_dkdv_recompute`,
in %."""
import re

from benchlib import peaks, work

KERNEL = re.compile(r"(?<![\w])bwd_(dq|dkdv)_recompute")


def is_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None


def read(view):
    m = view.config["matcher"]
    seconds = view.trace.device_seconds(is_kernel)
    if seconds <= 0:
        return None
    least = 0.0
    for n0, n1 in view.valid_counts:
        for a, b in zip(n0, n1):
            flops, nbytes = work.attention_backward_work(m, a, b)
            least += peaks.least_seconds(flops, nbytes, m["compute_dtype"])
    return 100.0 * least / seconds
