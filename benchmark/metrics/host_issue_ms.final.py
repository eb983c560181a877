"""host_issue_ms: host ms a frame spent outside its waits (the frame
record's ``host_ns`` less ``wait_ns``: Python, dispatch, launches), over
the window's untraced frames."""

from benchmark.harness import program_trace as pt


def read(rec):
    recs = pt.untraced(rec)
    return None if recs is None else pt.mean(
        (r.host_ns - r.wait_ns) / 1e6 for r in recs)
