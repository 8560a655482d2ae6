"""Device kernels per iteration in the profiled slice (copies and fills
left out)."""


def read(run):
    s = run.get("slice")
    if run["loop"] != "steady" or not s or not s["busy_s"]:
        return None
    return s["kernels"] / s["iterations"]
