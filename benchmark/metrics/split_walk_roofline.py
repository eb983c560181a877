"""split_walk_roofline: the split walks' least time over their device time
in the traced frames, in % of the H100's HBM roofline (3.35 TB/s).  Each
walk's least bytes (``harness/split_walk.split_walk_bytes``) take its rays
and resident rows from the harness's record of the call and the distinct
leaf rows it touched from the program's count of the same walk; the walks
are the kernels of the trace, in launch order."""

from benchmark.harness import split_walk, stats


def read(rec):
    walks = split_walk.stretch_walks(rec)
    us = split_walk.kernel_us(rec)
    if walks is None or us is None or len(us) != len(walks) or not sum(us):
        return None
    least = sum(stats.least_seconds(split_walk.split_walk_bytes(
        w["rays"], w["live"], w["table_bytes"], w["leaf_rows"]))
        for w in walks)
    return 100.0 * least / (sum(us) * 1e-6)
