"""The attention forward's share of its roofline (kernels 1 and 4,
impx_torch/csrc/attention.cu): the least time of the QK^T and P.V products
over the valid (query, key) pairs and of q, k, v and o moved once
(benchlib/work.py), at the peaks for the configuration's dtype, over the
device time of the kernels whose names start with `attn_fwd`, in %.

The names are the program's kernel names: a stopgap until spans inside the
program mark the attention."""
import re

from benchlib import peaks, work

KERNEL = re.compile(r"(?<![\w])attn_fwd")


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
            flops, nbytes = work.attention_forward_work(m, a, b)
            least += peaks.least_seconds(flops, nbytes, m["compute_dtype"])
    return 100.0 * least / seconds
