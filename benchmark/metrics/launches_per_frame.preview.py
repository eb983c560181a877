"""launches_per_frame: the device's kernels, copies and sets a traced
frame (every launch, the port's own kernels and PyTorch's)."""

from benchmark.harness import stats


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    return stats.launches_per_frame(tr)
