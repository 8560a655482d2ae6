"""Library-API walkthrough: multi-scale, multi-style stylization with an
averaged output image and the convergence-matched early stop — the
programmatic twin of the CLI (see README for the CLI forms), and of the JAX
package's ``examples/stylize.py``.

Run with real weights (the converter needs no JAX):
    python -m style_transfer_tpu_torch.scripts.convert_weights torch vgg19.pth vgg19.npz
    python -m style_transfer_tpu_torch.examples.stylize content.jpg style.jpg --weights vgg19.npz

Without weights it falls back to the port's deterministic random fixture
(useful to exercise the pipeline; the output is texture-like, not a
stylization). It runs on the NVIDIA GPU; ``--device cpu`` runs it on the CPU
(without a GPU and without that flag it exits 2).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("content")
    p.add_argument("styles", nargs="+")
    p.add_argument("--weights", default=None)
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--iterations", type=int, nargs="+", default=[500, 300, 200])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the NVIDIA GPU (default) or, only when asked, on the CPU")
    args = p.parse_args(argv)

    import torch

    from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.models.weights import load_npz, random_fixture
    from style_transfer_tpu_torch.optim import OptimizerSpec
    from style_transfer_tpu_torch.utils.imgio import load_image, save_image
    from style_transfer_tpu_torch.utils.progress import Printer, fanout

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if args.weights:
        params, mean, std = load_npz(args.weights)
    else:
        print("no --weights given: using the random fixture (pipeline demo only)")
        params, mean, std = random_fixture(0)

    st = StyleTransfer(params, mean=mean, std=std, device=args.device)

    # uint8 load: the [0,1] conversion happens on the device (4x less transfer)
    content = load_image(args.content, dtype=np.uint8)
    styles = [load_image(s, dtype=np.uint8) for s in args.styles]

    cfg = StylizeConfig(
        size=args.size,
        min_scale=min(256, args.size),     # coarse-to-fine ladder start
        iterations=tuple(args.iterations),  # per scale, last repeats
        style_blend_weights=None,          # e.g. [0.7, 0.3] for two styles
        optimizer=OptimizerSpec("adam", learning_rate=0.05),
        avg_decay=0.99,                    # Polyak-averaged output image
        stop_tol=1e-3,                     # convergence-matched early stop
    )
    out = st.stylize(content, styles, cfg, callback=fanout(Printer(every=50)))
    save_image(out, args.output)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
