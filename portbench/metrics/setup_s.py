"""Set-up: process start to the window's opening (weights, engine,
warm-up; the first run in a checkout also builds the kernels)."""


def read(run):
    return run["setup_s"]
