"""Host milliseconds per iteration inside the chunk dispatches of the
profiled image's first scale: the program's ``dispatch`` spans (the body of
``StyleTransfer._dispatch_chunk``) under its first ``scale`` span (index 0,
the smallest, where a step is short on the card and CUDA's launch queue
never fills), summed, over the sum of their ``steps``. Read from the
program's own spans (``style_transfer_tpu_torch.trace``), recorded while the
image is profiled; nothing where the program records none."""


def read(run):
    if run["loop"] != "ladder":
        return None
    try:
        from style_transfer_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    spans = trace.spans()
    calls = [s.call_id for s in spans if s.name == "stylize"]
    if not calls:
        return None
    mine = [s for s in spans if s.call_id == calls[-1]]
    first = {s.span_id for s in mine if s.name == "scale" and s.attrs.get("index") == 0}
    dispatches = [s for s in mine if s.name == "dispatch" and s.parent_id in first]
    steps = sum(s.attrs["steps"] for s in dispatches)
    if not steps:
        return None
    return sum(s.t1_ns - s.t0_ns for s in dispatches) / 1e6 / steps
