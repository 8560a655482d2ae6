"""A benchmark root with two tiny cells, built from the real configuration
and architecture files plus two workload files: each tiny cell holds the
limits of the calibrated cell of its kind, so a fault that passes here
would pass there, and reports the metrics of the benchmark's cell of its
loop."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny-adam": ("adam-2048", {"loop": "steady", "content_hw": [64, 64], "style_hw": [48, 48],
                                "stylize": {"size": 64, "min_scale": 64, "chunk_size": 4}}),
    "tiny-ladder": ("adam-ladder-2048", {"loop": "ladder", "content_hw": [64, 48],
                                         "style_hw": [48, 64],
                                         "stylize": {"size": 64, "min_scale": 32,
                                                     "iterations": [5, 4], "chunk_size": 4},
                                         "warm_iterations": [4, 4]}),
}


def make_root(root: Path) -> Path:
    """A copy of the benchmark's data files with the tiny cells added."""
    (root / "stbench" / "workloads").mkdir(parents=True, exist_ok=True)
    for data in ("configs", "arch"):
        shutil.copytree(REPO / "stbench" / data, root / "stbench" / data, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (like, body) in TINY.items():
        real = json.loads((REPO / "stbench" / "workloads" / f"{like}.json").read_text())
        wl = {"config": real["config"], "why": "tiny", "limits": real["limits"], **body}
        (root / "stbench" / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        manifest["workloads"].append({"name": name, "config": wl["config"], "traffic": name,
                                      "chips": 1, "why": "tiny"})
        if wl["config"] not in {c["name"] for c in manifest["configs"]}:
            file = f"stbench/configs/{wl['config']}.json"
            config = json.loads((REPO / file).read_text())
            manifest["configs"].append({"name": wl["config"], "source": config["source"],
                                        "file": file, "reduced": config["reduced"],
                                        "why": "tiny"})
        reports = "adam-2048" if body["loop"] == "steady" else "adam-ladder-2048"
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if reports in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("stbench_root"))


def run_cell(root: Path, name: str, capsys, seed: int = 3_000_000_019, trace: int = 0) -> dict:
    """One CPU run of a cell; its result line."""
    from stbench import run

    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0", "--trace",
                   str(trace)], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
