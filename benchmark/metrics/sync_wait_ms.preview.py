"""sync_wait_ms: host ms a frame blocked in the waits of
``host_syncs_per_frame`` (the frame record's ``wait_ns``), over the
window's untraced frames."""

from benchmark.harness import program_trace as pt


def read(rec):
    recs = pt.untraced(rec)
    return None if recs is None else pt.mean(r.wait_ns / 1e6 for r in recs)
