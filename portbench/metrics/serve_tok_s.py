"""Output tokens the window's ticks returned, over the window's seconds."""


def read(run):
    return run["tokens"] / run["window_s"]
