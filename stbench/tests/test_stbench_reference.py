"""The reference against the port's plain path at a tiny size on the CPU,
where the port runs every kernel's float32 plain version: every number the
comparison reads is at rounding, and the reference's own optimizer steps
follow the program's."""

import json
from pathlib import Path

import pytest
import torch

from stbench import inputs, manifest
from stbench.judge import NUMBERS, _adam, control_capture, follow, judge
from stbench.reference import resize as R
from stbench.reference.objective import Objective
from stbench.tests.conftest import run_cell

# the judge's numbers and the reference's own readings of each tiny cell's
# CPU run at seed 3_000_000_019, before the reference took its network from
# the configuration's architecture: {cell: (numbers, {scale: (reference
# losses along its steps, its change, its loss at the scale's start,
# Adam's count at the last chunk's start)})}
PINNED = {
    "tiny-adam": ({"start_tv": 1.0335420571517751e-07, "end_loss": 0.0, "end_change": 0.0,
                   "output": 0.0},
                  {"64x64": ([7.50540828704834, 7.120954990386963, 7.206993579864502],
                             5.457478046417236, 63.943355560302734, 12)}),
    "tiny-ladder": ({"start_tv": 0.0, "end_loss": 3.79651514078712e-07,
                     "end_change": 1.168064372494794e-07, "output": 0.0},
                    {"32x24": ([552.5363159179688], 2.041142463684082, 906.6763916015625, 4),
                     "64x48": ([623.8511352539062, 456.68841552734375, 321.53253173828125],
                               15.884960174560547, 623.8511352539062, None)}),
}


@pytest.mark.parametrize("name", ["tiny-adam", "tiny-ladder"])
def test_program_on_the_cpu_reads_at_rounding(tiny_root, capsys, name):
    result = run_cell(tiny_root, name, capsys)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(NUMBERS)
    for check, (value, limit) in result["checks"].items():
        assert value <= (0 if check == "output" else 1e-5), (check, value)
    assert list(result)[-1] == "checks"
    assert {"its_per_s", "image_s"} & set(result["metrics"]) and "setup_s" in result["metrics"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_judges_readings_are_the_pinned_ones(tiny_root, capsys, name):
    """The numbers agree with the pinned ones to the rounding that another
    CPU's float32 may move them by; the reference's own readings, which
    any change to its network or weights would move, to a millionth."""
    from stbench import run

    got = {}
    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", "3000000019", "--seconds", "0"], root=tiny_root,
                  device="cpu", after_judge=lambda r, cap, c, s, details: got.update(details))
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True
    numbers, scales = PINNED[name]
    assert {k: v for k, (v, _) in result["checks"].items()} == pytest.approx(numbers, abs=1e-6)
    assert result["checks"]["output"][0] == 0
    assert sorted(got) == sorted(scales)
    for hw, (losses, change, start_loss, count) in scales.items():
        assert got[hw]["ref_losses"] == pytest.approx(losses, rel=1e-6)
        assert got[hw]["ref_change"] == pytest.approx(change, rel=1e-6)
        assert got[hw]["ref_start_loss"] == pytest.approx(start_loss, rel=1e-6)
        assert got[hw]["count"] == count


def test_reference_steps_follow_the_program(tiny_root):
    """Each scale's last chunk of a ladder, from the program's state at its
    start: the reference's Adam lands on the program's image and moments."""
    from stbench.harness import Run

    cell = manifest.load_cell("tiny-ladder", tiny_root)
    run = Run(cell, 11, 0.0, False, torch.device("cpu"), 0.0)
    run.build()
    iterations = cell.stylize()["iterations"]
    run.stylize(0, iterations, capture=run.new_capture(iterations))
    cap, _ = run.checked
    content, style = inputs.images(11, 0, cell.workload["content_hw"], cell.workload["style_hw"],
                                   "cpu")
    obj = Objective(run.arch, run.params, run.mean, run.std, run.fields)
    c01, s01 = R.from_u8(content), R.from_u8(style)
    starts = [R.resize(c01 if s is None else s, hw)
              for (hw, _), s in zip(cap.scales, cap.sources())]
    followed = 0
    for (hw, _), start in zip(cap.scales, starts):
        tg = obj.targets(R.resize(c01, hw), R.resize(s01, R.style_size(tuple(style.shape[:2]), hw)))
        before = cap.before[hw]
        adam = _adam(run.fields["optimizer"], before, "cpu")
        losses, x = follow(obj, tg, adam, start if before is None else before.image,
                           len(cap.last[hw]))
        torch.testing.assert_close(x, cap.end[hw].image, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(adam.mu, cap.end[hw].mu, rtol=1e-4, atol=1e-7)
        assert losses == pytest.approx(cap.last[hw], rel=1e-5)
        assert cap.end[hw].count == adam.count
        followed += before is not None
    assert followed >= 1  # a scale whose last chunk starts from the program's state


def test_control_in_the_programs_place_is_judged_sound_without_rounding(tiny_root):
    """The control's arithmetic without its rounding is the judge's own: it
    reads nothing but the program's start."""
    from stbench.harness import Run

    cell = manifest.load_cell("tiny-ladder", tiny_root)
    run = Run(cell, 5, 0.0, False, torch.device("cpu"), 0.0)
    run.build()
    iterations = cell.stylize()["iterations"]
    run.stylize(0, iterations, capture=run.new_capture(iterations))
    cap, _ = run.checked
    content, style = inputs.images(5, 0, cell.workload["content_hw"], cell.workload["style_hw"],
                                   "cpu")
    ctl = control_capture(run.arch, cap, run.fields, content, style, run.params, run.mean,
                          run.std, "cpu", quant=lambda t: t)
    numbers = judge(run.arch, run.fields, ctl, content, style, run.params, run.mean, run.std,
                    "cpu")
    program = judge(run.arch, run.fields, cap, content, style, run.params, run.mean, run.std,
                    "cpu")
    assert numbers == {**dict.fromkeys(NUMBERS, 0.0), "start_tv": program["start_tv"]}


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import stbench.reference.objective, stbench.reference.optim, "
            "stbench.reference.resize, stbench.judge, stbench.inputs, stbench.flops; "
            "from stbench import manifest; [manifest.load_arch(p.stem) for p in "
            "(manifest.PACKAGE / 'arch').glob('*.py')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('style_transfer_tpu_torch', 'style_transfer_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[2]
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
