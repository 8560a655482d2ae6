"""The port's command line (``style_transfer_tpu_torch.cli``) against the JAX
package's: the same flags, defaults, choices and TOML overlay, the same
losses on the same weights file, and each departure's exit.

Both ``main()``s run in this process on the CPU: JAX pinned to the CPU by
``conftest.py`` (``--devices 0``: no mesh over its fake devices), the port
with ``--device cpu``. Post-Adam pixels are compared by their mean absolute
difference only (ROADMAP.md: near-zero gradients flip sign under Adam).
"""

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer_tpu import cli as jcli
from style_transfer_tpu.models.weights import random_fixture as jrandom_fixture
from style_transfer_tpu.models.weights import save_npz as jsave_npz
from style_transfer_tpu_torch import cli
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(REPO / "configs" / "*.toml")))

FAST = [
    "--size", "32", "--min-scale", "32", "--iterations", "4", "--chunk-size", "2",
    "--content-layers", "conv2_2", "--style-layers", "conv1_1", "conv2_1",
    "--random-weights", "--device", "cpu", "--print-every", "100",
]


@pytest.fixture()
def images(tmp_path):
    r = np.random.RandomState(0)
    content = str(tmp_path / "content.png")
    style = str(tmp_path / "style.png")
    imgio.save_image(r.rand(40, 32, 3).astype(np.float32), content)
    imgio.save_image(r.rand(32, 40, 3).astype(np.float32), style)
    return content, style


def _dests(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_surface_matches_the_jax_cli():
    """Every flag of the JAX parser, with its default and choices; ``device``
    is the one flag the port adds."""
    jax_actions, port_actions = _dests(jcli.build_parser()), _dests(cli.build_parser())
    assert set(port_actions) - set(jax_actions) == {"device"}
    for dest, ja in jax_actions.items():
        pa = port_actions[dest]
        assert pa.option_strings == ja.option_strings, dest
        assert pa.default == ja.default, dest
        assert pa.choices == ja.choices, dest
        assert pa.nargs == ja.nargs and pa.type == ja.type, dest
    assert port_actions["device"].choices == ["cuda", "cpu"]
    assert port_actions["device"].default == "cuda"


@pytest.mark.parametrize("flag", ["--list-layers", "--version"])
def test_simple_outputs_print_the_same_text(flag, capsys):
    """``--list-layers`` prints the same text; ``--version`` the same version
    under the port's program name."""
    outs = []
    for parser in (jcli.build_parser(), cli.build_parser()):
        with pytest.raises(SystemExit) as e:
            parser.parse_args([flag])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    assert outs[0].replace("style_transfer_tpu ", "style_transfer_tpu_torch ") == outs[1]
    if flag == "--list-layers":
        assert "vgg19: conv1_1" in outs[1] and "conv5_4" in outs[1]


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_shipped_configs_load_to_the_same_values(path):
    assert len(CONFIGS) == 5
    parsed = []
    for mod in (jcli, cli):
        parser = mod.build_parser()
        mod.load_config_defaults(parser, path)
        parsed.append(vars(parser.parse_args(["c.png", "s.png"])))
    jargs, pargs = parsed
    assert {k: pargs[k] for k in jargs} == jargs
    assert pargs["device"] == "cuda"


def test_config_toml_rejects_unknown_key(tmp_path, images):
    content, style = images
    cfgfile = tmp_path / "bad.toml"
    cfgfile.write_text("sizee = 32\n")
    with pytest.raises(SystemExit, match="unknown config key 'sizee'"):
        cli.main([content, style, "--config", str(cfgfile)])


def test_config_toml_defaults_and_override(tmp_path, images):
    content, style = images
    cfgfile = tmp_path / "run.toml"
    cfgfile.write_text(
        'size = 32\nmin-scale = 32\niterations = [4]\nchunk-size = 2\n'
        'content-layers = ["conv2_2"]\nstyle-layers = ["conv1_1"]\n'
        'random-weights = true\ndevice = "cpu"\n'
    )
    out, metrics = str(tmp_path / "o.png"), str(tmp_path / "m.json")
    assert cli.main([content, style, "-o", out, "--config", str(cfgfile), "--iterations", "2",
                     "--metrics-out", metrics]) == 0
    with open(metrics) as f:
        assert [r["iteration"] for r in json.load(f)["records"]] == [2]  # the flag won


def test_losses_match_the_jax_cli_on_one_weights_file(tmp_path, capsys):
    """JAX's fixture written with JAX's ``save_npz``; both CLIs at 32 px, four
    Adam steps of one each, fp32 on the CPU: every step's loss at rtol 1e-4.
    The post-Adam PNGs have one shape; their mean absolute difference was 0
    here (the same uint8 pixels; the limit 1e-2 of full scale leaves room
    for Adam's sign flips)."""
    weights = str(tmp_path / "vgg.npz")
    params, mean, std = jrandom_fixture(0)
    jsave_npz(weights, params, mean, std)
    r = np.random.RandomState(3)
    content, style = str(tmp_path / "c.png"), str(tmp_path / "s.png")
    imgio.save_image(r.rand(32, 32, 3).astype(np.float32), content)
    imgio.save_image(r.rand(40, 32, 3).astype(np.float32), style)
    common = [content, style, "--weights", weights, "--size", "32", "--min-scale", "32",
              "-i", "4", "--chunk-size", "1", "--precision", "fp32", "--print-every", "100"]
    runs = {}
    for name, mod, extra in (("jax", jcli, ["--devices", "0"]),
                             ("port", cli, ["--device", "cpu"])):
        out, metrics = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.json")
        assert mod.main(common + extra + ["-o", out, "--metrics-out", metrics]) == 0
        with open(metrics) as f:
            runs[name] = ([rec["loss"] for rec in json.load(f)["records"]],
                          imgio.load_image(out))
    (jloss, jimg), (ploss, pimg) = runs["jax"], runs["port"]
    assert len(ploss) == 4
    np.testing.assert_allclose(ploss, jloss, rtol=1e-4)
    assert pimg.shape == jimg.shape == (32, 32, 3)
    assert float(np.abs(pimg - jimg).mean()) < 1e-2


@pytest.mark.parametrize("flags, message", [
    (["--packed-block1", "on"], "--unfused"),
    (["--packed-block2", "off"], "--fused-block1"),
    (["--packed-block3", "on"], "structural gates"),
    (["--packed-block4", "off"], "only auto"),
    (["--grid-snap", "on"], "--grid-snap auto or off"),
    (["--devices", "99"], "CUDA device(s) visible"),
    (["--precision", "fp32"], "--unfused for the plain path in fp32"),
])
def test_departures_exit_2_with_their_message(images, capsys, flags, message):
    content, style = images
    assert cli.main([content, style, "--random-weights"] + flags) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--grid-snap", "off"], ["--grid-snap", "auto"], ["--devices", "1"], ["--devices", "0"],
    ["--no-pipeline"], ["--precision", "fp32"], ["--precision", "bf16"], ["--unfused"],
    ["--remat", "on"], ["--fused-block1"], ["--debug-nans"],
])
def test_accepted_flags_run(tmp_path, images, flags):
    content, style = images
    out = str(tmp_path / "o.png")
    assert cli.main([content, style, "-o", out] + FAST + flags) == 0
    assert imgio.load_image(out).shape == (32, 26, 3)


def test_no_card_exits_2_without_device_cpu(images, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the CLI runs on it")
    content, style = images
    assert cli.main([content, style, "--random-weights", "--size", "32"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_requires_weights(tmp_path, images, capsys):
    content, style = images
    assert cli.main([content, style, "-o", str(tmp_path / "o.png"), "--device", "cpu"]) == 2
    assert "weights" in capsys.readouterr().err


def test_end_to_end_with_metrics_and_debug_checks(tmp_path, images):
    content, style = images
    out, metrics = str(tmp_path / "result.png"), str(tmp_path / "metrics.json")
    assert cli.main([content, style, "-o", out, "--metrics-out", metrics, "--debug-checks"]
                    + FAST) == 0
    assert imgio.load_image(out).shape == (32, 26, 3)  # 40x32 -> long side 32, even-rounded
    with open(metrics) as f:
        data = json.load(f)
    assert [r["iteration"] for r in data["records"]] == [2, 4]
    assert data["summary"]["final_loss"] == data["records"][-1]["loss"] > 0
    assert set(data["summary"]) == {"per_scale_its_per_sec", "per_scale_chunks_counted",
                                    "final_loss"}


def test_snapshots(tmp_path, images):
    content, style = images
    out = str(tmp_path / "snap.png")
    assert cli.main([content, style, "-o", out, "--snapshot-every", "2"] + FAST) == 0
    snap = imgio.load_image(str(tmp_path / "snap_snapshot.png"), dtype=np.uint8)
    np.testing.assert_array_equal(snap, imgio.load_image(out, dtype=np.uint8))


def test_init_from_image_path(tmp_path, images):
    content, style = images
    assert cli.main([content, style, "-o", str(tmp_path / "o.png"), "--init", style]
                    + FAST) == 0


def test_checkpoint_every_and_resume(tmp_path, images):
    """``--checkpoint-every 2`` over four steps saves steps 2 and 4; resuming
    from step 2 ends on the uninterrupted run's bits."""
    content, style = images
    ckdir = tmp_path / "ck"
    full = str(tmp_path / "full.png")
    assert cli.main([content, style, "-o", full, "--checkpoint-dir", str(ckdir),
                     "--checkpoint-every", "2"] + FAST) == 0
    steps = sorted(int(p.name.split("_")[1]) for p in ckdir.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [2, 4]
    import shutil

    shutil.rmtree(ckdir / "step_4")
    resumed = str(tmp_path / "resumed.png")
    assert cli.main([content, style, "-o", resumed, "--checkpoint-dir", str(ckdir),
                     "--resume"] + FAST) == 0
    np.testing.assert_array_equal(imgio.load_image(resumed, dtype=np.uint8),
                                  imgio.load_image(full, dtype=np.uint8))


def test_profile_dir_writes_a_trace(tmp_path, images):
    content, style = images
    prof = tmp_path / "trace"
    assert cli.main([content, style, "-o", str(tmp_path / "o.png"), "--profile-dir",
                     str(prof)] + FAST) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any("conv" in str(n) for n in names)


def test_web_monitor_serves_during_the_run_and_stops(tmp_path, images):
    import socket
    import threading

    content, style = images
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    before = {t for t in threading.enumerate() if t.name == "web-monitor"}
    assert cli.main([content, style, "-o", str(tmp_path / "o.png"), "--web", "--port",
                     str(port)] + FAST) == 0
    assert {t for t in threading.enumerate() if t.name == "web-monitor"} == before
    with socket.socket() as sock:  # the server let go of its port
        sock.bind(("127.0.0.1", port))


def test_python_dash_m_version():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "style_transfer_tpu_torch", "--version"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "style_transfer_tpu_torch 0.1.0"
