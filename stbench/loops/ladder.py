"""Whole images, back to back: each a full ``stylize`` ladder with uint8
output on its own images from the seed.

Set-up runs one image at the cell's ``warm_iterations`` (one chunk a
scale), which warms every shape and chunk length. The window runs images
until ``--seconds`` have passed, and finishes the one in flight. The image
the comparison judges is drawn from the seed among the window's first two.
A traced run profiles one more whole image after the window.
"""

from __future__ import annotations

import time

from stbench import flops


def run(run) -> dict:
    iterations = list(run.fields["iterations"])
    run.stylize(-1, run.wl["warm_iterations"])
    capture = run.new_capture(iterations)
    t0 = run.open_window()
    sample = run.seed % 2
    images = 0
    while True:
        events = []
        run.stylize(images, iterations, capture=capture if images == sample else None,
                    on_event=events.append)
        images += 1
        run.attempted += 1
        run.failed += not all(run.count_chunk(ev.losses) for ev in events)
        if time.perf_counter() - t0 >= run.seconds and images > sample:
            break
    window_s = time.perf_counter() - t0
    scales = run.scales(iterations)
    per_image = flops.flops_per_ladder(run.arch, run.fields, scales)
    run.data.update(images=images, window_s=window_s, flops_per_image=per_image,
                    peak_bytes=run.peak_bytes())
    if run.traced:
        run.start_profile()
        run.stylize(images, iterations)
        run.stop_profile()
        run.read_profile(sum(n for _, n in scales), per_image)
    return {"image_s": window_s / images}
