"""The Sinkhorn head's share of its roofline (kernel 2,
impx_torch/csrc/sinkhorn.cu): the least time of its iterations' products
over the valid (N+1) x (M+1) block and of reading the valid distances once
and writing its outputs (benchlib/work.py; EIMP's 15 heads at its
buckets), at the peaks for the configuration's dtype, over the device time
of the kernels named `sinkhorn_persistent`, in %."""
import re

from benchlib import peaks, work

KERNEL = re.compile(r"(?<![\w])sinkhorn_persistent\b")


def is_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None


def read(view):
    m = view.config["matcher"]
    every = view.config["model"] == "AdaGMN"
    seconds = view.trace.device_seconds(is_kernel)
    if seconds <= 0:
        return None
    least = 0.0
    for n0, n1 in view.valid_counts:
        for a, b in zip(n0, n1):
            flops, nbytes = work.sinkhorn_work(m, a, b, every)
            least += peaks.least_seconds(flops, nbytes, m["compute_dtype"])
    return 100.0 * least / seconds
