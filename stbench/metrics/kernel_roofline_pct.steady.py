"""All kernels together against the roofline: model FLOPs of the profiled
slice's iterations over the device's busy time there (the union of its
kernel and copy intervals), against the dense bf16 peak, in percent. At
these shapes the FLOP bound is the larger of the two."""


def read(run):
    s = run.get("slice")
    if run["loop"] != "steady" or not s or not s["busy_s"] or not run.get("peak_flops"):
        return None
    return 100.0 * s["flops"] / s["busy_s"] / run["peak_flops"]
