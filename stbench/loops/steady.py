"""Steady optimizer iterations at one scale.

Set-up runs the cell's call for two chunks and a short last one, which
warms every shape and chunk length the window uses and gives the rate that
sizes the window's call: the window's iterations are the rate times
``--seconds``, in whole chunks, and then a last chunk of three steps, which
the comparison follows step by step from the program's state at its start.
The window runs from the end of that call's first chunk (the card
synchronized there) to the call's return, so its chunks are queued as a
user's are, two ahead. In a traced run the window closes after its whole
chunks; the profiled slice is the two chunks after them, the card
synchronized before and after it, and one more chunk and the last follow.
"""

from __future__ import annotations

import math
import time

from stbench import flops
from stbench.capture import STEPS


def run(run) -> dict:
    chunk = int(run.fields["chunk_size"])
    warm = []
    run.stylize(-1, [2 * chunk + STEPS], on_event=warm.append)
    rates = [ev.its_per_sec for ev in warm if len(ev.losses["loss"]) == chunk]
    rate = rates[-1] if math.isfinite(rates[-1]) else 0.0
    w_chunks = max(2, round(rate * run.seconds / chunk))
    traced_chunks = 3 * chunk if run.traced else 0
    total = chunk + w_chunks * chunk + traced_chunks + STEPS
    n_window = w_chunks * chunk + (0 if run.traced else STEPS)
    t_close = {}

    def on_chunk(i):
        if i == 1:
            run.open_window()
        elif run.traced and i == 1 + w_chunks:
            run.sync()
            t_close["t"] = time.perf_counter()
            run.start_profile()
        elif run.traced and i == 3 + w_chunks:
            run.stop_profile()

    events = []
    run.on_chunk = on_chunk
    run.stylize(0, [total], capture=run.new_capture([total]), on_event=events.append)
    t_end = time.perf_counter()
    run.on_chunk = None
    window_s = t_close.get("t", t_end) - run.window_t0
    for ev in events:
        if chunk < ev.iteration <= chunk + n_window:
            run.attempted += 1
            run.failed += not run.count_chunk(ev.losses)
    hw = tuple(events[-1].size)
    per_it = flops.flops_per_eval(run.arch, run.fields, hw)
    run.read_profile(2 * chunk, 2 * chunk * per_it)
    run.data.update(window_its=n_window, window_s=window_s, flops_per_it=per_it)
    return {"its_per_s": n_window / window_s}
