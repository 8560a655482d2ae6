"""The card's idle share of the profiled slice, in percent."""


def read(run):
    s = run.get("slice")
    if run["loop"] != "steady" or not s or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
