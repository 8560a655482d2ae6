"""The 1x1-convolution GEMM kernel (``csrc/conv1x1.cu``) against its
roofline over the profiled slice, in percent: the summed least time of its
launches there (``stbench/launch_work.py``: the larger of each launch's
operations at the bf16 peak and its bytes at the memory's, from the shapes
the program's launch counter recorded) over the kernel's device seconds
(``device_op_s``, by its symbol). It carries ResNet-50's 1x1 convolutions,
its projections and, on im2col'd columns, its strided ones, forward and
backward-data. Nothing where the program launches no such kernel."""

from stbench import launch_work


def read(run):
    s = run.get("slice")
    if run["loop"] != "steady" or not s or not run.get("peak_flops"):
        return None
    try:
        from style_transfer_tpu_torch import trace
    except ImportError:  # a program without launch counts of its own
        return None
    return launch_work.roofline_pct(trace.counts(), s.get("device_op_s", {}), launch_work.CONV1X1,
                                    launch_work.conv1x1, launch_work.CONV1X1_SYMBOL,
                                    run["peak_flops"])
