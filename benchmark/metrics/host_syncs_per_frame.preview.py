"""host_syncs_per_frame: the waits on the card a frame (the tracer's
frame record: every readback and every copy of host values to the card,
counted where the program makes it), over the window's untraced
frames."""

from benchmark.harness import program_trace as pt


def read(rec):
    recs = pt.untraced(rec)
    return None if recs is None else pt.mean(r.waits for r in recs)
