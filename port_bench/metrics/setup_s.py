"""setup_s: seconds from process start to the window's start: imports,
the kernel build (on a first run), the scene, the runner, the checked
first steps and the warm-up."""


def read(rec):
    return rec.get("setup_s")
