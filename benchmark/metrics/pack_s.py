"""pack_s: host seconds of the configuration's scene build and the
program's pack (``Scene.pack`` inside ``ProgressiveRenderer``), part of
set-up."""


def read(rec):
    return rec["pack_s"]
