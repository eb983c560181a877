"""msamples_per_s: width x height x one-sample passes completed in the
window, over the window's seconds, in millions: all the work and all the
time, readbacks included."""


def read(rec):
    if not rec["window_s"]:
        return None
    return rec["pixels_per_pass"] * rec["passes"] / rec["window_s"] / 1e6
