"""The benchmark's one hook into the program's internals: ``stylize`` calls
``StyleTransfer._dispatch_chunk`` once per chunk, and the hook passes its
arguments and result through. A program that changes this fails here, and
the steady window and the traced slice would need another hook."""

import numpy as np
import torch

from stbench import inputs, manifest
from stbench.harness import watch_dispatch


def test_stylize_dispatches_once_per_chunk_through_the_hook():
    from style_transfer_tpu_torch.api import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.optim import OptimizerSpec

    cell = manifest.load_cell("adam-2048")
    params = cell.arch.weights(3, "cpu", cell.config)
    st = StyleTransfer(params, mean=inputs.IMAGENET_MEAN, std=inputs.IMAGENET_STD,
                       device=torch.device("cpu"))
    seen = []
    watch_dispatch(st, lambda: seen.append("before"), lambda: seen.append("after"))
    content, style = inputs.images(3, 0, (32, 32), (32, 32), "cpu")
    cfg = StylizeConfig(size=32, min_scale=16, iterations=(5, 3), chunk_size=2,
                        optimizer=OptimizerSpec("adam", learning_rate=0.05))
    events = []
    out = st.stylize(content.numpy(), style.numpy(), cfg, callback=events.append,
                     output_dtype="uint8")
    # scale 1: chunks of 2, 2, 1; scale 2: 2, 1
    assert seen == ["before", "after"] * 5, "StyleTransfer._dispatch_chunk is not called once per chunk"
    assert [len(ev.losses["loss"]) for ev in events] == [2, 2, 1, 2, 1]
    assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
