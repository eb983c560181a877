"""setup_s: seconds from the process's start to the window's start:
imports, the kernels from their build cache (or built, in a checkout's
first run), the scene's build and pack, the warm-up frame and readback."""


def read(rec):
    return rec["setup_s"]
