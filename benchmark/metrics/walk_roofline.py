"""walk_roofline: the walks' least time over their device time in the
traced frames, in % of the H100's HBM roofline (3.35 TB/s).  Each walk
call's bytes come from its inputs (``harness/stats.walk_bytes``: 52 B a
live ray, 24 B a dead one, the table once, 16 B of stats); the calls are
matched in launch order to the walk kernels of the trace."""

from benchmark.harness import stats
from benchmark.harness.trace import WALK_KERNELS, own_kernel


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["walks"]:
        return None
    kernels = [dur for name, cat, _, dur in tr["device"]
               if cat == "kernel" and own_kernel(name, WALK_KERNELS)]
    if len(kernels) != len(tr["walks"]) or not sum(kernels):
        return None
    least = sum(stats.least_seconds(stats.walk_bytes(
        c["rays"], c["live"], c["table_bytes"])) for c in tr["walks"])
    return 100.0 * least / (sum(kernels) * 1e-6)
