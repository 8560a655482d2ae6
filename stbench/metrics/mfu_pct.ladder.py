"""Model FLOPs of the window's images over the window's host time, against
the card's dense bf16 peak, in percent (an iteration counts one objective
evaluation; target captures are left out)."""


def read(run):
    if run["loop"] != "ladder" or not run.get("peak_flops"):
        return None
    return 100.0 * run["images"] * run["flops_per_image"] / run["window_s"] / run["peak_flops"]
