"""The port's optimizer, schedule and progress modules against the JAX
package: Adam against ``optax.adam`` step by step, the scale ladder and
chunking against ``schedule.py``, and the progress sinks."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from style_transfer_tpu import schedule as jschedule
from style_transfer_tpu.optim import OptimizerSpec as JSpec
from style_transfer_tpu.optim import make_step_fn as j_make_step_fn
from style_transfer_tpu_torch import schedule
from style_transfer_tpu_torch.optim import OptimizerSpec, make_chunk_fn, make_step_fn
from style_transfer_tpu_torch.utils.progress import MetricsRecorder, Printer, ProgressEvent

torch.set_num_threads(2)


def _quadratic(x, lib):
    return lib.sum((x - 0.3) ** 2 * (1.0 + x)) + 0.1 * lib.sum(x ** 4)


@pytest.mark.parametrize("spec_kw", [{}, {"learning_rate": 0.2, "beta1": 0.5, "beta2": 0.9, "eps": 1e-4}])
def test_adam_matches_optax(spec_kw):
    x0 = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    spec, jspec = OptimizerSpec(**spec_kw), JSpec(**spec_kw)
    opt, jopt = spec.build(), jspec.build()
    x, state = torch.from_numpy(x0), None
    jx, jstate = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
    state = opt.init(x)
    for _ in range(6):
        xr = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_quadratic(xr, torch), xr)
        x, state = opt.update(g, state, x)
        jg = jax.grad(lambda v: _quadratic(v, jnp))(jx)
        updates, jstate = jopt.update(jg, jstate, jx)
        jx = optax.apply_updates(jx, updates)
        # atol 1e-5 on O(1) values: Adam divides by sqrt(nu), which turns an
        # fp32 rounding difference in a near-zero gradient into a step
        # difference; the formula itself is the same
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)


def test_step_and_chunk_fns_match_jax_step():
    """make_step_fn's loss trajectory equals the JAX make_step_fn's, and
    make_chunk_fn stacks per-step terms."""
    x0 = np.random.RandomState(1).rand(1, 4, 5, 3).astype(np.float32)

    def tobj(x):
        loss = _quadratic(x, torch)
        return loss, {"loss": loss, "half": 0.5 * loss}

    def jobj(x):
        loss = _quadratic(x, jnp)
        return loss, {"loss": loss, "half": 0.5 * loss}

    step, opt = make_step_fn(tobj, OptimizerSpec())
    jstep, jopt = j_make_step_fn(jobj, JSpec())
    run = make_chunk_fn(step, 4)
    x, state, losses = run(torch.from_numpy(x0), opt.init(torch.from_numpy(x0)))
    assert set(losses) == {"loss", "half"} and tuple(losses["loss"].shape) == (4,)
    jx, jstate, jl = jnp.asarray(x0), jopt.init(jnp.asarray(x0)), []
    for _ in range(4):
        jx, jstate, aux = jstep(jx, jstate)
        jl.append(float(aux["loss"]))
    np.testing.assert_allclose(losses["loss"].numpy(), jl, rtol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)


def test_lbfgs_names_the_roadmap_item_and_unknown_raises():
    """L-BFGS, the ROADMAP item this test once named as missing, builds with
    the JAX spec's defaults; an unknown name still raises."""
    spec = OptimizerSpec("lbfgs")
    assert (spec.memory_size, spec.max_linesearch_steps, spec.linesearch_tol) == \
        (JSpec("lbfgs").memory_size, JSpec("lbfgs").max_linesearch_steps,
         JSpec("lbfgs").linesearch_tol) == (10, 16, 1e-3)
    assert spec.needs_value_fn and not OptimizerSpec().needs_value_fn
    opt = spec.build()
    state = opt.init(torch.zeros(2, 3))
    assert opt.memory_size == 10 and tuple(state.lbfgs.diff_params_memory.shape) == (10, 2, 3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptimizerSpec("sgd").build()


@pytest.mark.parametrize(
    "end, min_scale, factor",
    [((512, 512), 256, 2.0), ((1024, 768), 256, 2.0), ((64, 52), 32, 2.0),
     ((1360, 900), 300, 1.5), ((24, 24), 256, 2.0), ((9, 900), 64, 2.0)],
)
def test_scale_ladder_matches_jax(end, min_scale, factor):
    assert schedule.scale_ladder(end, min_scale=min_scale, factor=factor) == \
        jschedule.scale_ladder(end, min_scale=min_scale, factor=factor)
    plan = schedule.build_plan(end, (7, 3), min_scale=min_scale, factor=factor)
    jplan = jschedule.build_plan(end, (7, 3), min_scale=min_scale, factor=factor)
    assert [(s.index, s.size, s.iterations) for s in plan] == \
        [(s.index, s.size, s.iterations) for s in jplan]


def test_chunk_lengths_and_errors_match_jax():
    for it, c in [(500, 50), (7, 3), (3, 10), (0, 5)]:
        assert schedule.chunk_lengths(it, c) == jschedule.chunk_lengths(it, c)
    assert [schedule._round_even(v) for v in (1, 9, 10.9, 255)] == \
        [jschedule._round_even(v) for v in (1, 9, 10.9, 255)]
    with pytest.raises(ValueError, match="factor"):
        schedule.scale_ladder((64, 64), factor=1.0)
    with pytest.raises(ValueError, match="iteration"):
        schedule.build_plan((64, 64), ())


def _event(scale, it, losses, rate, done=False):
    return ProgressEvent(
        scale_index=scale, num_scales=2, size=(24, 32), iteration=it, total_iterations=4,
        losses={k: np.asarray(v, np.float32) for k, v in losses.items()},
        its_per_sec=rate, get_image=lambda: np.zeros((24, 32, 3), np.float32), done=done,
    )


def test_printer_and_metrics_recorder():
    terms = {"loss": [3.0, 2.0], "content": [1, 1], "style": [1, 0.5], "tv": [0.1, 0.1]}
    buf = io.StringIO()
    p = Printer(every=2, out=buf)
    rec = MetricsRecorder()
    for ev in (_event(0, 2, terms, 5.0), _event(0, 4, terms, 7.0), _event(1, 2, terms, 3.0, done=True)):
        p(ev)
        rec(ev)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 3 and lines[0].startswith("scale 1/2  32x24  iter 2/4  loss 2")
    s = rec.summary()
    assert s["per_scale_its_per_sec"] == {0: 7.0, 1: 3.0}  # first chunk of a scale dropped
    assert s["per_scale_chunks_counted"] == {0: 1, 1: 1}
    assert s["final_loss"] == 2.0
