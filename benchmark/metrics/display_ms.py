"""display_ms: the median host time of ``display_rgba8`` (the post kernel,
the copy to the host, the numpy array) over the window's readbacks, in
ms."""

import statistics


def read(rec):
    if not rec["display_s"]:
        return None
    return statistics.median(rec["display_s"]) * 1e3
