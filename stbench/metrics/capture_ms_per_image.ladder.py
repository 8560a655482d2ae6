"""Host milliseconds of the profiled image's target captures: the
program's ``capture`` spans of that ``stylize`` call (each scale's content
and style images resized, their targets captured and blended), summed. Read
from the program's own spans (``style_transfer_tpu_torch.trace``), recorded
while the image is profiled; nothing where the program records none."""


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
    captures = [s for s in spans if s.call_id == calls[-1] and s.name == "capture"]
    if not captures:
        return None
    return sum(s.t1_ns - s.t0_ns for s in captures) / 1e6
