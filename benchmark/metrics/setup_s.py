"""setup_s: seconds from the process's start to the window's: imports,
the world and its bank or grid, the engine and its plans, the warm days."""

UNIT = "s"


def read(run):
    return run.setup_s
