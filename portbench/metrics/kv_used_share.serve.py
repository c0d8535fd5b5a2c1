"""Tokens the paged cache holds over the tokens it reserves (slots x
max_len), the mean over the window's ticks, read from the engine's
``kv.lengths`` before each tick (traced runs)."""


def read(run):
    if "len_sum" not in run or not run["ticks"]:
        return None
    return 100.0 * run["len_sum"] / (run["ticks"] * run["slots"]
                                     * run["max_len"])
