"""Command-line interface (PyTorch port): ``python -m style_transfer_tpu_torch``.

Counterpart of ``style_transfer_tpu/cli.py``: the same flags, groups,
defaults and choices, the same TOML overlay (``--config``, CLI flags win,
an unknown key is an error), and the same run: load the weights and images,
build a :class:`~style_transfer_tpu_torch.api.StylizeConfig`, stylize with
the progress sinks, save the image (and ``--metrics-out``).

Where each flag goes:

- ``content``, ``styles``, ``--init`` (a mode, or a path to an init image),
  ``--size`` ... ``--style-scale``, ``--pooling``, ``--seed``, ``--avg-decay``,
  ``--stop-tol``, ``--stop-patience``, ``--chunk-size``, ``--debug-checks``,
  ``--fused-block1`` and ``--remat`` map 1:1 onto ``StylizeConfig`` fields;
  ``--unfused`` is ``use_fused=False``, the plain path everywhere;
  ``--no-pipeline`` is ``pipeline_chunks=False`` (no flag: ``None``, auto);
- ``--optimizer``, ``--lr``, ``--lbfgs-memory``, ``--linesearch-tol``:
  ``OptimizerSpec``;
- ``--weights``: ``models.weights.load_npz``; ``--random-weights`` with
  ``--arch``: the port's numpy-drawn fixture ``random_fixture(0, arch)``,
  whose values differ from the JAX package's ``jax.random`` draw;
- ``--print-every``: ``Printer``; ``--metrics-out``: ``MetricsRecorder.dump``;
  ``--snapshot-every``: ``utils.snapshots.SnapshotSaver``; ``--checkpoint-dir``,
  ``--checkpoint-every``, ``--resume``: ``utils.ckpt.CheckpointManager`` and
  ``stylize(resume_state=...)``; ``--web``, ``--host``, ``--port``,
  ``--browser``: ``web.WebMonitor`` (imported only then: it needs aiohttp).

The port's departures, each an exit with code 2 and a message where the
flag asks for what the port does not do:

- ``--device {cuda,cpu}`` (default ``cuda``) is the one new flag, the port's
  form of the reference's ``JAX_PLATFORMS=cpu`` pin: without a card the CLI
  runs on the CPU only with ``--device cpu``, and otherwise exits 2;
- ``--devices``: as the reference (``cli.py:241-247``), unset shards over
  every visible card when there is more than one, N > 1 over
  ``cuda:0..N-1`` (``parallel.mesh.make_mesh``), 0 or 1 run on ``cuda:0``;
  N above the visible count exits 2 with the count. With ``--device cpu``,
  ``--devices N`` is a mesh of N CPU shards, the counterpart of the
  reference's forced CPU devices;
- ``--precision``: ``bf16`` or unset is bf16 on the card and fp32 on the CPU
  (the plain versions there are the fp32 oracle); ``fp32`` on the card needs
  ``--unfused`` (the kernels compute in bf16), else exit 2;
- ``--packed-block1`` ... ``--packed-block4``: ``auto`` only; the port's chain
  engages by its structural gates alone, so ``on`` and ``off`` exit 2;
- ``--grid-snap``: ``auto`` and ``off`` keep the exact sizes (the port never
  snaps: the 16-row grid is a TPU device); ``on`` exits 2;
- ``--debug-nans``: ``torch.autograd.set_detect_anomaly(True, check_nan=True)``
  for the run, the port's form of ``jax_debug_nans``;
- ``--profile-dir``: ``torch.profiler.profile`` (CPU, and CUDA on the card)
  over the run, written as a Chrome trace (``*.pt.trace.json``) into the
  directory.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import List, Optional

from style_transfer_tpu_torch.models.vgg import DEFAULT_CONTENT_LAYERS, DEFAULT_STYLE_LAYERS


class _ListLayers(argparse.Action):
    """--list-layers: print each architecture's capturable layers and exit."""

    def __init__(self, option_strings, dest, **kw):
        kw.setdefault("nargs", 0)
        super().__init__(option_strings, dest, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        from style_transfer_tpu_torch.models.vgg import ARCH_BLOCKS, layer_names

        for arch in sorted(ARCH_BLOCKS):
            print(f"{arch}: " + " ".join(layer_names(arch)))
        parser.exit(0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="style_transfer_tpu_torch",
        description="Neural style transfer (Gatys VGG-19 family) on PyTorch and "
                    "hand-written CUDA kernels for the H100.",
    )
    from style_transfer_tpu_torch import __version__

    p.add_argument("content", help="content image path")
    p.add_argument("styles", nargs="+", help="style image path(s)")
    p.add_argument("-o", "--output", default="out.png", help="output image path")
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    p.add_argument("--list-layers", action=_ListLayers,
                   help="print capturable layer names per architecture and exit")

    g = p.add_argument_group("scales")
    g.add_argument("-s", "--size", type=int, default=512, help="final long side in px")
    g.add_argument("--min-scale", type=int, default=256, help="coarsest long side in px")
    g.add_argument("--scale-factor", type=float, default=2.0, help="per-scale growth factor")
    g.add_argument(
        "-i", "--iterations", type=int, nargs="+", default=[500],
        help="iterations per scale, coarse to fine (last repeats)",
    )

    g = p.add_argument_group("objective")
    g.add_argument("--content-weight", type=float, default=1.0)
    g.add_argument("--style-weight", type=float, default=256.0)
    g.add_argument("--tv-weight", type=float, default=2.0)
    g.add_argument("--content-layers", nargs="+", default=list(DEFAULT_CONTENT_LAYERS))
    g.add_argument("--style-layers", nargs="+", default=list(DEFAULT_STYLE_LAYERS))
    g.add_argument("--content-layer-weights", type=float, nargs="+", default=None)
    g.add_argument("--style-layer-weights", type=float, nargs="+", default=None)
    g.add_argument(
        "--style-blend-weights", type=float, nargs="+", default=None,
        help="relative weight per style image (multi-style Gram blending)",
    )
    g.add_argument("--style-scale", type=float, default=1.0,
                   help="style image long side relative to the current scale")
    g.add_argument("--pooling", choices=["average", "max"], default="average")

    g = p.add_argument_group("optimizer")
    g.add_argument("--optimizer", choices=["adam", "lbfgs"], default="adam")
    g.add_argument("--lr", "--learning-rate", dest="lr", type=float, default=0.05)
    g.add_argument("--lbfgs-memory", type=int, default=10)
    g.add_argument("--linesearch-tol", type=float, default=1e-3,
                   help="absolute epsilon on the L-BFGS Wolfe conditions "
                        "(absorbs bf16 gradient noise at megapixel sizes)")
    g.add_argument("--init", default="content",
                   help="'content', 'random', 'mean', or a path to an init image")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--avg-decay", type=float, default=0.0,
                   help="EMA decay for iterate averaging: the saved/displayed "
                        "image is a moving average of the optimizer iterates "
                        "(0 disables)")
    g.add_argument("--stop-tol", type=float, default=0.0,
                   help="relative per-chunk loss improvement below which a scale "
                        "stops early (0 disables; convergence-matched runs)")
    g.add_argument("--stop-patience", type=int, default=2)

    g = p.add_argument_group("model weights")
    g.add_argument("--weights", default=None,
                   help="VGG-19 .npz weights (see scripts/convert_weights.py)")
    g.add_argument("--random-weights", action="store_true",
                   help="use the deterministic random fixture (tests/benches): this "
                        "package's numpy-drawn weights, not the JAX package's "
                        "jax.random draw of the same seed")
    g.add_argument("--arch", choices=["vgg19", "vgg16"], default="vgg19",
                   help="model family for --random-weights (.npz files carry "
                        "their own meta.arch)")

    g = p.add_argument_group("execution")
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the NVIDIA GPU (default; exits 2 without one) or, "
                        "only when asked, on the CPU")
    g.add_argument("--devices", type=int, default=None,
                   help="shard spatially over the first N devices (default: all "
                        "visible cards; 0 or 1: one card); with --device cpu, N CPU "
                        "shards")
    g.add_argument("--precision", choices=["bf16", "fp32"], default=None,
                   help="activation compute dtype (default and bf16: bf16 on the "
                        "card, fp32 on the CPU; fp32 on the card needs --unfused)")
    g.add_argument("--unfused", action="store_true",
                   help="disable the hand-written CUDA kernels and run the plain "
                        "PyTorch objective everywhere")
    g.add_argument("--remat", choices=["auto", "on", "off"], default="auto",
                   help="recompute the VGG forward in the backward instead of "
                        "storing activations (auto: on from a pixel count "
                        "measured on the H100, see api.REMAT_AUTO_PIXELS)")
    g.add_argument("--no-pipeline", action="store_true",
                   help="process chunks sequentially instead of queueing two "
                        "chunks ahead (the same bits; only host scheduling "
                        "differs)")
    g.add_argument("--packed-block1", choices=["auto", "on", "off"], default="auto",
                   help="the reference's block-1 kernel switch; the port's chain "
                        "engages by its structural gates alone: auto only")
    g.add_argument("--packed-block2", choices=["auto", "on", "off"], default="auto",
                   help="as --packed-block1, for block 2: auto only")
    g.add_argument("--packed-block3", choices=["auto", "on", "off"], default="auto",
                   help="as --packed-block1, for block 3: auto only")
    g.add_argument("--packed-block4", choices=["auto", "on", "off"], default="auto",
                   help="as --packed-block1, for block 4: auto only")
    g.add_argument("--fused-block1", action="store_true",
                   help="run VGG block 1 through the one-pass block1_full kernel "
                        "and blocks 2-5 plain, instead of the kernel chain")
    g.add_argument("--grid-snap", choices=["auto", "on", "off"], default="auto",
                   help="the reference snaps the ladder onto its TPU kernels' "
                        "grid; the port keeps exact sizes (auto and off), on "
                        "exits 2")
    g.add_argument("--chunk-size", type=int, default=50,
                   help="optimizer steps per host read of the losses")
    g.add_argument("--print-every", type=int, default=25)

    g = p.add_argument_group("observability")
    g.add_argument("--web", action="store_true", help="serve a live progress page")
    g.add_argument("--port", type=int, default=8080, help="web monitor port")
    g.add_argument("--host", default="127.0.0.1", help="web monitor bind host")
    g.add_argument("--browser", action="store_true",
                   help="open the live progress page in the default browser "
                        "(implies --web)")
    g.add_argument("--snapshot-every", type=int, default=0,
                   help="save the in-progress image every N iterations (0 off)")
    g.add_argument("--metrics-out", default=None, help="write run metrics JSON here")
    g.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run into this "
                        "directory")
    g.add_argument("--checkpoint-dir", default=None,
                   help="periodically checkpoint {image, opt state, schedule position}")
    g.add_argument("--checkpoint-every", type=int, default=200,
                   help="iterations between checkpoints (with --checkpoint-dir)")
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    g.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection with NaN checks: raise "
                        "at the op that made a NaN")
    g.add_argument("--debug-checks", action="store_true",
                   help="verify every fetched loss term is finite; raise with "
                        "scale/iteration coordinates otherwise")
    return p


def load_config_defaults(parser: argparse.ArgumentParser, path: str) -> None:
    """Overlay a TOML table onto the parser defaults (CLI flags still win).

    Keys use the flag names with ``-`` or ``_`` (``style-weight = 1e3``).
    Unknown keys are an error — typos in configs must not pass silently.
    """
    import tomllib

    with open(path, "rb") as f:
        table = tomllib.load(f)
    valid = {a.dest for a in parser._actions}
    overlay = {}
    for key, value in table.items():
        dest = key.replace("-", "_")
        if dest not in valid:
            raise SystemExit(f"error: unknown config key {key!r} in {path}")
        overlay[dest] = value
    parser.set_defaults(**overlay)


def _departure(args: argparse.Namespace) -> Optional[str]:
    """The message for a flag value the port does not carry out, or None."""
    for block in (1, 2, 3, 4):
        if getattr(args, f"packed_block{block}") != "auto":
            return (f"--packed-block{block} {getattr(args, f'packed_block{block}')}: the "
                    "port's kernel chain engages by its structural gates alone, so only "
                    "auto is accepted; use --unfused for the plain path or --fused-block1 "
                    "for the one-pass block-1 kernel")
    if args.grid_snap == "on":
        return ("--grid-snap on: the port never snaps the scale ladder (the 16-row grid "
                "is a TPU device; its kernels take any even size); use --grid-snap auto "
                "or off")
    if args.precision == "fp32" and args.device == "cuda" and not args.unfused:
        return ("--precision fp32: the CUDA kernels compute in bf16; use --precision "
                "bf16, or --unfused for the plain path in fp32")
    return None


def main(argv: Optional[List[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, rest = pre.parse_known_args(argv)

    parser = build_parser()
    parser.add_argument("--config", default=None,
                        help="TOML file of flag defaults (CLI flags override)")
    if pre_args.config:
        load_config_defaults(parser, pre_args.config)
    args = parser.parse_args(argv)

    msg = _departure(args)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from style_transfer_tpu_torch.api import NO_CUDA_MESSAGE, StyleTransfer, StylizeConfig
    from style_transfer_tpu_torch.models.weights import load_npz, random_fixture
    from style_transfer_tpu_torch.optim import OptimizerSpec
    from style_transfer_tpu_torch.parallel.mesh import make_mesh
    from style_transfer_tpu_torch.utils import imgio
    from style_transfer_tpu_torch.utils.progress import MetricsRecorder, Printer, fanout

    if args.weights:
        params, mean, std = load_npz(args.weights)
    elif args.random_weights:
        params, mean, std = random_fixture(0, arch=args.arch)
    else:
        print(
            "error: no VGG-19 weights. Pass --weights vgg19.npz (convert with "
            "scripts/convert_weights.py) or --random-weights for a fixture run.",
            file=sys.stderr,
        )
        return 2

    if args.device == "cuda":
        visible = torch.cuda.device_count()
        if args.devices is not None and args.devices > max(visible, 1):
            print(f"error: --devices {args.devices}: {visible} CUDA device(s) visible",
                  file=sys.stderr)
            return 2
        if not torch.cuda.is_available():
            print(f"error: {NO_CUDA_MESSAGE} (--device cpu)", file=sys.stderr)
            return 2
        device = "cuda:0"
        n_mesh = visible if args.devices is None else args.devices
        mesh = make_mesh(n_mesh) if n_mesh > 1 else None
    else:
        device = "cpu"
        n_mesh = args.devices or 1
        mesh = make_mesh(devices=["cpu"] * n_mesh) if n_mesh > 1 else None
    if mesh is not None:
        print(f"mesh: {mesh.size} devices ({', '.join(map(str, mesh.devices))}), "
              "activations split along H", flush=True)

    compute_dtype = None  # bf16 on the card, fp32 on the CPU
    if args.precision == "fp32":
        compute_dtype = torch.float32
    elif args.precision == "bf16" and device == "cpu":
        print("--precision bf16: the CPU runs the plain versions in fp32", flush=True)

    st = StyleTransfer(params, mean=mean, std=std, pooling=args.pooling,
                       compute_dtype=compute_dtype, device=device, mesh=mesh)

    # uint8 until on-device conversion: 4x less host->device traffic.
    content = imgio.load_image(args.content, dtype=np.uint8)
    styles = [imgio.load_image(s, dtype=np.uint8) for s in args.styles]

    init_image = None
    init_mode = args.init
    if init_mode not in ("content", "random", "mean"):
        init_image = imgio.load_image(init_mode, dtype=np.uint8)
        init_mode = "content"

    cfg = StylizeConfig(
        size=args.size,
        min_scale=args.min_scale,
        scale_factor=args.scale_factor,
        iterations=tuple(args.iterations),
        chunk_size=args.chunk_size,
        content_layers=tuple(args.content_layers),
        style_layers=tuple(args.style_layers),
        content_layer_weights=args.content_layer_weights,
        style_layer_weights=args.style_layer_weights,
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        tv_weight=args.tv_weight,
        style_blend_weights=args.style_blend_weights,
        style_scale=args.style_scale,
        optimizer=OptimizerSpec(
            args.optimizer, learning_rate=args.lr, memory_size=args.lbfgs_memory,
            linesearch_tol=args.linesearch_tol,
        ),
        init=init_mode,
        seed=args.seed,
        avg_decay=args.avg_decay,
        stop_tol=args.stop_tol,
        stop_patience=args.stop_patience,
        use_fused=not args.unfused,
        fused_block1=args.fused_block1,
        pipeline_chunks=False if args.no_pipeline else None,
        debug_checks=args.debug_checks,
        remat={"auto": None, "on": True, "off": False}[args.remat],
    )

    metrics = MetricsRecorder()
    callbacks = [Printer(every=args.print_every), metrics]

    if args.snapshot_every > 0:
        from style_transfer_tpu_torch.utils.snapshots import SnapshotSaver

        callbacks.append(SnapshotSaver(args.output, every=args.snapshot_every))

    ckpt = None
    if args.checkpoint_dir:
        from style_transfer_tpu_torch.utils.ckpt import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir, every=args.checkpoint_every)
        callbacks.append(ckpt.callback)

    with contextlib.ExitStack() as stack:  # unwound in reverse, errors included
        if args.web or args.browser:
            from style_transfer_tpu_torch.web import WebMonitor

            web_server = WebMonitor(host=args.host, port=args.port)
            web_server.start()
            stack.callback(web_server.stop)
            callbacks.append(web_server.callback)
            url = f"http://{args.host}:{args.port}/"
            print(f"live view: {url}", flush=True)
            if args.browser:
                import webbrowser

                webbrowser.open(url)
        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if device != "cpu":
                activities.append(ProfilerActivity.CUDA)
            stack.enter_context(profile(
                activities=activities, on_trace_ready=tensorboard_trace_handler(args.profile_dir)))
            if device != "cpu":
                stack.callback(torch.cuda.synchronize)  # the trace ends after the device work
        if args.debug_nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True, check_nan=True))

        resume_state = ckpt.latest() if (ckpt and args.resume) else None
        out = st.stylize(
            content,
            styles,
            cfg,
            callback=fanout(*callbacks),
            init_image=init_image,
            resume_state=resume_state,
            # headed straight for an 8-bit file: quantize on the device, fetch
            # 4x less over the host link
            output_dtype="uint8",
        )

    imgio.save_image(out, args.output)
    print(f"saved {args.output}", flush=True)
    if args.metrics_out:
        metrics.dump(args.metrics_out)
        print(f"metrics -> {args.metrics_out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
