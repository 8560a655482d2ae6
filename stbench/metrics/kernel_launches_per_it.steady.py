"""The program's own kernel launches per iteration in the profiled slice:
the launches its kernel wrappers counted while the slice was profiled
(``style_transfer_tpu_torch.trace.counts()``, every wrapper but the line
search's host reads, which launch nothing), over the slice's iterations.
Beside ``launches_per_it.steady`` (every device kernel) it splits the
step's launches into the port's kernels and PyTorch's. Nothing where the
program counts none."""

HOST_READS = "linesearch.host_reads"


def read(run):
    s = run.get("slice")
    if run["loop"] != "steady" or not s or not s["iterations"]:
        return None
    try:
        from style_transfer_tpu_torch import trace
    except ImportError:  # a program without launch counts of its own
        return None
    launches = sum(n for (wrapper, _, _), n in trace.counts().items() if wrapper != HOST_READS)
    if not launches:
        return None
    return launches / s["iterations"]
