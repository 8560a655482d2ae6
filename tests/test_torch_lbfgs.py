"""The port's L-BFGS (``optim.LBFGS``) and zoom line search
(``linesearch.py``) against optax's, which the JAX package runs.

L-BFGS: on a quadratic-like function and on Rosenbrock, for each memory size
and line-search tolerance, every step starts both optimizers from the same
state (optax's, grafted onto the port's template by ``restore_opt_state``),
so each step compares the algorithm alone; free-running trajectories drift
apart by fp32 rounding, amplified by Rosenbrock's curvature (2e-3 after 25
steps). The iterate, the value, the learning rate and the line-search
errors agree at rtol 1e-5; the line-search step counts are equal.

Line search: hand-made one-dimensional problems that reach each branch of
``zoom_linesearch``, compared with optax's after every step. The decrease
error is a difference of nearly equal values, so it is held to rtol 1e-5
plus a few fp32 ulps of the value it cancels (XLA and PyTorch round that
difference apart by one ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import linesearch as optax_ls

from style_transfer_tpu.optim import OptimizerSpec as JSpec
from style_transfer_tpu_torch import linesearch as LS
from style_transfer_tpu_torch.optim import OptimizerSpec, state_leaves
from style_transfer_tpu_torch.utils.ckpt import flatten_opt_state, restore_opt_state

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _rosenbrock(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _bumpy_quadratic(x, lib):
    return lib.sum((x - 0.3) ** 2 * (1.0 + 0.5 * lib.cos(3 * x))) + 0.1 * lib.sum(x ** 4)


PROBLEMS = {"rosenbrock": (_rosenbrock, (6,)), "quadratic": (_bumpy_quadratic, (2, 3, 4))}


def _torch_value_and_grad(fn):
    def value_fn(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fn(x)
            (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), g

    return value_fn


@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("memory_size", [1, 5, 10])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_lbfgs_matches_optax_step_by_step(problem, memory_size, tol):
    fn, shape = PROBLEMS[problem]
    x0 = np.random.RandomState(0).randn(*shape).astype(np.float32)
    spec = dict(memory_size=memory_size, linesearch_tol=tol)
    opt, jopt = OptimizerSpec("lbfgs", **spec).build(), JSpec("lbfgs", **spec).build()
    value_fn = _torch_value_and_grad(lambda v: fn(v, torch))
    jfn = lambda v: fn(v, jnp)  # noqa: E731
    jvg = jax.jit(jax.value_and_grad(jfn))
    jupdate = jax.jit(lambda g, s, x, v: jopt.update(g, s, x, value=v, grad=g, value_fn=jfn))
    jx, jstate = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
    template = opt.init(torch.from_numpy(x0))
    steps = []
    for _ in range(15):
        jleaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
        state = restore_opt_state(template, jleaves)
        x = torch.from_numpy(np.array(jx))
        loss, g = value_fn(x)
        updates, state = opt.update(g, state, x, value=loss, value_fn=value_fn)
        x = x + updates

        jloss, jg = jvg(jx)
        jupdates, jstate = jupdate(jg, jstate, jx, jloss)
        jx = optax.apply_updates(jx, jupdates)

        p, j = flatten_opt_state(state), [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
        assert [(a.shape, a.dtype) for a in p] == [(b.shape, b.dtype) for b in j]
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p[7], j[7], rtol=1e-5)  # value at the new iterate
        np.testing.assert_allclose(p[6], j[6], rtol=1e-5)  # learning_rate
        assert int(p[9]) == int(j[9])  # num_linesearch_steps
        scale = 4 * EPS32 * max(1.0, abs(float(j[7])))
        np.testing.assert_allclose(p[10], j[10], rtol=1e-5, atol=scale)  # decrease_error
        np.testing.assert_allclose(p[11], j[11], rtol=1e-5, atol=scale)  # curvature_error
        assert int(p[0]) == int(j[0])  # count
        steps.append(int(j[9]))
    assert max(steps) >= 2 or problem == "rosenbrock"  # the searches do more than accept


def test_make_step_fn_matches_the_jax_step():
    """``make_step_fn`` with L-BFGS: value and gradient with aux, the update
    whose line search calls the objective, then ``image + updates``."""
    from style_transfer_tpu.optim import make_step_fn as j_make_step_fn
    from style_transfer_tpu_torch.optim import make_step_fn

    fn, shape = PROBLEMS["quadratic"]
    x0 = np.random.RandomState(1).rand(*shape).astype(np.float32)
    step, opt = make_step_fn(lambda x: (fn(x, torch), {"loss": fn(x, torch)}),
                             OptimizerSpec("lbfgs", memory_size=5))
    jstep, jopt = j_make_step_fn(lambda x: (fn(x, jnp), {"loss": fn(x, jnp)}),
                                 JSpec("lbfgs", memory_size=5))
    x, state = torch.from_numpy(x0), opt.init(torch.from_numpy(x0))
    jx, jstate = jnp.asarray(x0), jopt.init(jnp.asarray(x0))
    jstep = jax.jit(jstep)
    for _ in range(4):
        x, state, aux = step(x, state)
        jx, jstate, jaux = jstep(jx, jstate)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
        assert int(state.linesearch.num_linesearch_steps) == int(
            jstate[2].info.num_linesearch_steps)


def test_state_has_optax_leaves_in_optax_order():
    """Twelve L-BFGS leaves, three of Adam, with optax's shapes and dtypes."""
    x = np.zeros((1, 4, 5, 3), np.float32)
    for name, n in (("lbfgs", 12), ("adam", 3)):
        p = flatten_opt_state(OptimizerSpec(name, memory_size=7).build().init(torch.from_numpy(x)))
        j = [np.asarray(l) for l in jax.tree_util.tree_leaves(
            JSpec(name, memory_size=7).build().init(jnp.asarray(x)))]
        assert len(p) == len(j) == n
        assert [(a.shape, a.dtype) for a in p] == [(b.shape, b.dtype) for b in j]
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a, b)
    lb = OptimizerSpec("lbfgs").build().init(torch.from_numpy(x))
    assert [f.name for f in dataclasses.fields(lb.lbfgs)] == list(
        optax.ScaleByLBFGSState._fields)
    assert len(state_leaves(lb)) == 12


def test_lbfgs_rejects_empty_memory():
    with pytest.raises(ValueError, match="memory_size"):
        OptimizerSpec("lbfgs", memory_size=0).build()


def test_one_host_read_per_linesearch_step():
    fn, shape = PROBLEMS["quadratic"]
    x = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(np.float32))
    opt = OptimizerSpec("lbfgs", memory_size=5).build()
    value_fn = _torch_value_and_grad(lambda v: fn(v, torch))
    state = opt.init(x)
    for _ in range(8):
        before = LS.host_reads.n
        loss, g = value_fn(x)
        updates, state = opt.update(g, state, x, value=loss, value_fn=value_fn)
        x = x + updates
        assert LS.host_reads.n - before == int(state.linesearch.num_linesearch_steps) >= 1


# ------------------------------------------------------------ line search


def _optax_branch(s) -> str:
    """Which trial optax's next step makes from state ``s``."""
    if not bool(s.interval_found):
        return "search"
    delta = jnp.abs(s.high - s.low)
    left, right = jnp.minimum(s.high, s.low), jnp.maximum(s.high, s.low)
    cubic = optax_ls._cubicmin(s.low, s.value_low, s.slope_low, s.high, s.value_high,
                               s.cubic_ref, s.value_cubic_ref)
    if (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta):
        return "cubic"
    quad = optax_ls._quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
    if (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta):
        return "quadratic"
    return "bisection"


KINK = 0.31415


def _relu(x, lib):
    return jax.nn.relu(x) if lib is jnp else torch.relu(x)


# name -> (f(x, lib), x0, direction, max steps, tol, branches reached, how it ends)
LINE_PROBLEMS = {
    "interval growth": (lambda x, lib: lib.sum((x - 100.0) ** 2), 0.0, 1.0, 16, 0.0,
                        {"search"}, "done"),
    "quadratic": (lambda x, lib: lib.sum((x - 0.3) ** 2), 0.0, 1.0, 16, 0.0,
                  {"search", "quadratic"}, "done"),
    "cubic": (lambda x, lib: lib.sum(lib.sqrt((x - 0.3) ** 2 + 1e-12)), 0.0, 1.0, 30, 0.0,
              {"search", "quadratic", "cubic"}, "done"),
    "bisection": (lambda x, lib: lib.sum((x - 0.02) ** 2), 0.0, 1.0, 16, 0.0,
                  {"search", "bisection", "quadratic"}, "done"),
    "safe step at the step limit": (lambda x, lib: lib.sum(lib.sqrt((x - 0.3) ** 2 + 1e-12)),
                                    0.0, 1.0, 4, 0.0, {"search", "quadratic", "cubic"}, "safe"),
    "tol accepts the curvature": (lambda x, lib: lib.sum(lib.sqrt((x - 0.3) ** 2 + 1e-12)),
                                  0.0, 1.0, 4, 0.2, {"search", "quadratic"}, "done"),
    "interval too small": (lambda x, lib: lib.sum(_relu(KINK - x, lib) + 2 * _relu(x - KINK, lib)),
                           0.0, 1.0, 30, 0.0, {"search", "quadratic", "cubic"}, "too small"),
    "not a descent direction": (lambda x, lib: lib.sum(x ** 2), 1.0, 1.0, 16, 0.0,
                                {"search", "bisection"}, "unsafe"),
    "outside the domain": (lambda x, lib: lib.sum(-lib.log(0.5 - x) - 3 * x), 0.0, 1.0, 16, 0.0,
                           {"search", "bisection", "quadratic"}, "done"),
    "steps exhausted": (lambda x, lib: lib.sum(x ** 2), 1.0, 1.0, 3, 0.0,
                        {"search", "bisection"}, "unsafe"),
}


@pytest.mark.parametrize("name", sorted(LINE_PROBLEMS))
def test_zoom_linesearch_matches_optax(name):
    fn, x0, u, max_steps, tol, branches, ending = LINE_PROBLEMS[name]
    init, step, cond = optax_ls.zoom_linesearch(max_steps, tol=tol)
    jvg = jax.value_and_grad(lambda x: fn(x, jnp))
    step = jax.jit(lambda s: optax_ls.zoom_linesearch(max_steps, tol=tol)[1](
        s, value_and_grad_fn=jvg, fn_kwargs={}))
    jx, ju = jnp.asarray([x0], jnp.float32), jnp.asarray([u], jnp.float32)
    value, grad = jvg(jx)
    js = init(ju, jx, value=value, grad=grad, prev_stepsize=jnp.asarray(1.0),
              initial_guess_strategy="keep")

    search = LS.ZoomLinesearch(max_steps, tol=tol)
    value_fn = _torch_value_and_grad(lambda x: fn(x, torch))
    tx, tu = torch.tensor([x0]), torch.tensor([u])
    value, grad = value_fn(tx)
    ts = search.init(tu, tx, value=value, grad=grad, prev_stepsize=torch.tensor(1.0))

    seen = []
    while bool(cond(js)):
        seen.append(_optax_branch(js))
        js = step(js)
        ts = search.step(ts, value_fn)
        scale = 4 * EPS32 * max(1.0, abs(float(js.value_init)))
        for f in dataclasses.fields(LS.ZoomState):
            a = np.asarray(getattr(ts, f.name), np.float64)
            b = np.asarray(getattr(js, f.name), np.float64)
            atol = scale if f.name == "decrease_error" else 0.0
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, equal_nan=True, err_msg=f.name)
        assert bool(LS.ZoomLinesearch.cond(ts)) == bool(cond(js))
    assert set(seen) == branches
    failed, done = bool(js.failed), bool(js.done)
    too_small = float(jnp.abs(js.high - js.low)) <= 1e-5
    ended = ("done" if done else "too small" if too_small
             else "safe" if float(js.safe_stepsize) > 0 else "unsafe")
    assert ended == ending and failed == (ending != "done")
    if ending == "unsafe":  # not a descent direction: no step size decreases the value
        assert float(js.slope_init) > 0 or int(js.count) == max_steps


def test_run_matches_the_while_loop():
    """``ScaleByZoomLinesearch.update`` against optax's transform on a
    problem whose search zooms: step, state and one host read per step."""
    fn = LINE_PROBLEMS["cubic"][0]
    jt = optax.scale_by_zoom_linesearch(30, tol=0.0)
    jx = jnp.asarray([0.0], jnp.float32)
    value, grad = jax.value_and_grad(lambda x: fn(x, jnp))(jx)
    jupdates, jstate = jt.update(jnp.asarray([1.0]), jt.init(jx), jx, value=value, grad=grad,
                                 value_fn=lambda x: fn(x, jnp))
    tt = LS.ScaleByZoomLinesearch(30, tol=0.0)
    tx = torch.tensor([0.0])
    value_fn = _torch_value_and_grad(lambda x: fn(x, torch))
    value, grad = value_fn(tx)
    before = LS.host_reads.n
    tupdates, tstate = tt.update(torch.tensor([1.0]), tt.init(tx), tx, value=value, grad=grad,
                                 value_fn=value_fn)
    assert LS.host_reads.n - before == int(tstate.num_linesearch_steps) == int(
        jstate.info.num_linesearch_steps)
    np.testing.assert_allclose(tupdates.numpy(), np.asarray(jupdates), rtol=1e-5)
    for a, b in zip(state_leaves(tstate), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


def _points(seed):
    """Random points, and degenerate ones: coincident abscissae, zero
    slope, flat values, overflow, inf and NaN. None produces a subnormal on
    the way: XLA on the CPU flushes those to zero and PyTorch does not."""
    r = np.random.RandomState(seed)
    rand = r.randn(64, 7).astype(np.float32)
    degenerate = np.array([
        [0, 1, -1, 0, 1, 2, 5],       # b == a
        [0, 1, -1, 1, 2, 0, 1],       # c == a
        [0, 1, -1, 1, 2, 1, 2],       # c == b
        [0, 1, 0, 1, 1, 2, 1],        # flat, zero slope
        [0, 1, -1, 1, 0, 2, 1],       # zero curvature in the quadratic
        [0, 1, -1, 1, np.inf, 2, 1],  # infinite value
        [0, 1, -1, 1, np.nan, 2, 1],  # NaN value
        [0, np.nan, -1, 1, 2, 2, 1],
        [0, 1, -1, np.inf, 2, 2, 1],
        [0, 1e20, -1e20, 1, 1e20, 2, 1e20],  # overflow to inf on the way
        [0, 1, -1, 1, 2, 2, 30],      # negative radical
    ], np.float32)
    return np.concatenate([rand, degenerate])


@pytest.mark.parametrize("seed", [0, 1])
def test_cubicmin_and_quadmin_match_optax(seed):
    pts = _points(seed)
    with np.errstate(all="ignore"):
        for row in pts:
            a, fa, fpa, b, fb, c, fc = row
            jc = float(optax_ls._cubicmin(*[jnp.float32(v) for v in row]))
            tc = float(LS._cubicmin(*[torch.tensor(v) for v in row]))
            jq = float(optax_ls._quadmin(*[jnp.float32(v) for v in row[:5]]))
            tq = float(LS._quadmin(*[torch.tensor(v) for v in row[:5]]))
            np.testing.assert_allclose(tc, jc, rtol=1e-5, equal_nan=True, err_msg=str(row))
            np.testing.assert_allclose(tq, jq, rtol=1e-5, equal_nan=True, err_msg=str(row))
