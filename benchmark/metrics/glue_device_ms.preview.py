"""glue_device_ms: device time a traced frame of every kernel, copy and
set that is not one of the port's own CUDA kernels (the walks, tristream,
post_rgba8), in ms."""

from benchmark.harness.trace import own_kernel


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    us = sum(dur for name, _, _, dur in tr["device"] if not own_kernel(name))
    return us / 1e3 / tr["frames"]
