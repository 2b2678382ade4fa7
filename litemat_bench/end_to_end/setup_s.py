"""Seconds from the process's start to the window's opening: imports, the
device, the data, the program's build and the warm-up."""


def read(run):
    return run.setup_s
