"""post_rgba8_roofline: the post kernel's least time over its device time
in the traced frames, in % of the H100's HBM roofline (3.35 TB/s): 20 B a
pixel (a float4 read, an RGBA8 write) of every image the frames read
back."""

from benchmark.harness import stats
from benchmark.harness.trace import own_kernel


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    kernels = [dur for name, cat, _, dur in tr["device"]
               if cat == "kernel" and own_kernel(name, ("post_rgba8",))]
    if not kernels or not sum(kernels):
        return None
    h, w = rec["image_hw"]
    least = len(kernels) * stats.least_seconds(stats.post_bytes(h, w))
    return 100.0 * least / (sum(kernels) * 1e-6)
