"""Model FLOPs of the window's iterations over the window's host time,
against the card's dense bf16 peak, in percent."""


def read(run):
    if run["loop"] != "steady" or not run.get("peak_flops"):
        return None
    return 100.0 * run["window_its"] * run["flops_per_it"] / run["window_s"] / run["peak_flops"]
