"""``stylize()`` with L-BFGS, early stop, the sanitizer, resumable state and
checkpoints, against the JAX package.

Both packages use the JAX fixture weights and the same numpy images, fp32 on
the CPU; JAX runs its plain-XLA objective (``use_fused=False``), the port its
chain's plain versions. Per-step losses agree at rtol 1e-4. The one-step
parity resumes both packages from the JAX package's own state after its
first chunk, so both take the next step from the same L-BFGS memory: its
losses and all twelve state leaves agree at rtol 1e-5 of each leaf's largest
entry. It is one step because a second one can land on a kink of the
objective (a ReLU input at zero): in a measured case two steps on, the port's
gradient departed from JAX's by 5.9e-4 of its largest entry at a point where
a tiny move brought it back within 2e-6.
"""

import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.optim import OptimizerSpec as JOptimizerSpec
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.utils.ckpt import (
    CheckpointManager,
    flatten_opt_state,
    restore_opt_state,
)
from style_transfer_tpu_torch.utils.progress import fanout

torch.set_num_threads(2)

TERMS = ("loss", "content", "style", "tv")
# Adam's normalized step turns fp32 differences in near-zero gradients into
# whole-step pixel moves (test_torch_api.py), so over nine steps a scale its
# losses drift apart by up to 1.1e-4; L-BFGS's stay within 1e-5.
RTOL = {"adam": 1e-3, "lbfgs": 1e-4}


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    jst = JStyleTransfer(jparams, mean=mean, std=std)
    pst = StyleTransfer(from_numpy_params(jparams), mean=mean, std=std, device="cpu")
    return jst, pst


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(42)
    return r.rand(64, 48, 3).astype(np.float32), r.rand(48, 64, 3).astype(np.float32)


def _run(packages, images, optimizer, *, jax_side=True, callback=True, **kw):
    """Both packages' ``stylize`` with the same settings: (port events,
    port output, JAX events, JAX output)."""
    jst, pst = packages
    content, style = images
    resume = kw.pop("resume_state", None)
    jev, pev = [], []
    jout = None
    if jax_side:
        jout = jst.stylize(content, style, JStylizeConfig(
            warm_compile=False, use_fused=False, optimizer=JOptimizerSpec(optimizer), **kw),
            callback=jev.append, resume_state=resume)
    pout = pst.stylize(content, style, StylizeConfig(optimizer=OptimizerSpec(optimizer), **kw),
                       callback=pev.append if callback else None, resume_state=resume)
    return pev, pout, jev, jout


def _same_events(pev, jev, rtol=1e-4):
    assert [(e.scale_index, e.size, e.iteration, e.total_iterations, e.done) for e in pev] == \
        [(e.scale_index, e.size, e.iteration, e.total_iterations, e.done) for e in jev]
    for pe, je in zip(pev, jev):
        for k in TERMS:
            np.testing.assert_allclose(pe.losses[k], je.losses[k], rtol=rtol, atol=1e-9)


def _leaf_close(p, j, rtol=1e-5):
    assert [(a.shape, a.dtype) for a in p] == [(b.shape, b.dtype) for b in j]
    for i, (a, b) in enumerate(zip(p, j)):
        if b.size:
            np.testing.assert_allclose(a, b, rtol=0, atol=rtol * float(np.abs(b).max()),
                                       err_msg=f"leaf {i}")


def test_lbfgs_loss_curve_matches_jax(packages, images):
    """Two-scale ladder (32 -> 64), four L-BFGS steps a scale in chunks of
    two: per-step loss terms, events and the state at each chunk's end."""
    pev, pout, jev, jout = _run(packages, images, "lbfgs", size=64, min_scale=32,
                                iterations=(4,), chunk_size=2)
    _same_events(pev, jev)
    assert pout.shape == jout.shape == (64, 48, 3)
    assert np.isfinite(pout).all() and pev[-1].done
    for pe, je in zip(pev, jev):
        ps, js = pe.get_state(), je.get_state()
        assert len(ps["opt_state_leaves"]) == len(js["opt_state_leaves"]) == 12
        np.testing.assert_allclose(ps["image"], js["image"], rtol=0, atol=1e-4)
        assert int(ps["iteration"]) == int(js["iteration"])
        assert int(ps["scale_index"]) == int(js["scale_index"])


def test_one_step_parity_from_the_jax_state(packages, images):
    """JAX's ``get_state()`` after its first chunk resumes both packages:
    the next step's losses and every state leaf agree."""
    kw = dict(size=64, min_scale=32, iterations=(3,), chunk_size=1)
    _, _, jev, _ = _run(packages, images, "lbfgs", **kw)
    saved = jev[0].get_state()
    pev, _, jev2, _ = _run(packages, images, "lbfgs", resume_state=saved, **kw)
    assert pev[0].iteration == jev2[0].iteration == 2
    for k in TERMS:
        np.testing.assert_allclose(pev[0].losses[k], jev2[0].losses[k], rtol=1e-5, atol=1e-9)
    _leaf_close(pev[0].get_state()["opt_state_leaves"], jev2[0].get_state()["opt_state_leaves"])
    _same_events(pev, jev2)


def _small(**kw):
    base = dict(size=32, min_scale=32, iterations=(30,), chunk_size=3,
                content_layers=("conv2_2",), style_layers=("conv1_1", "conv2_1"))
    base.update(kw)
    return base


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_early_stop_matches_jax(packages, images, optimizer):
    """``stop_tol=1`` counts every chunk as a stall: each scale stops after
    ``stop_patience`` + 1 chunks, the next scale still runs, and the last
    event carries ``done=True``; events and losses as the JAX package's."""
    pev, pout, jev, jout = _run(packages, images, optimizer,
                                **_small(size=64, stop_tol=1.0, stop_patience=2))
    _same_events(pev, jev, RTOL[optimizer])
    assert [e.iteration for e in pev] == [3, 6, 9, 3, 6, 9]
    assert pev[-1].done and not any(e.done for e in pev[:-1])
    if optimizer == "lbfgs":  # Adam's pixels are not compared (test_torch_api.py)
        np.testing.assert_allclose(pout, jout, atol=1e-4)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_early_stop_off_and_patience_match_jax(packages, images, optimizer):
    """``stop_tol=0`` runs every iteration; a small tolerance stops where the
    JAX package stops."""
    pev, _, jev, _ = _run(packages, images, optimizer,
                          **_small(iterations=(12,), stop_tol=0.0, stop_patience=1))
    _same_events(pev, jev, RTOL[optimizer])
    assert pev[-1].iteration == 12
    pev, _, jev, _ = _run(packages, images, optimizer,
                          **_small(iterations=(15,), stop_tol=0.05, stop_patience=1))
    _same_events(pev, jev, RTOL[optimizer])


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_debug_checks_raise_like_jax(packages, images, optimizer):
    """A NaN init image: with ``debug_checks`` both raise the same
    ``FloatingPointError``; without it the run ends on NaN losses."""
    jst, pst = packages
    content, style = images
    bad = np.full((32, 24, 3), np.nan, np.float32)
    kw = _small(iterations=(2,), chunk_size=2, debug_checks=True)
    errors = []
    for st, cfg in ((jst, JStylizeConfig(warm_compile=False, use_fused=False,
                                         optimizer=JOptimizerSpec(optimizer), **kw)),
                    (pst, StylizeConfig(optimizer=OptimizerSpec(optimizer), **kw))):
        with pytest.raises(FloatingPointError, match="non-finite") as err:
            st.stylize(content, style, cfg, init_image=bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    events = []
    pst.stylize(content, style, StylizeConfig(optimizer=OptimizerSpec(optimizer),
                                              **dict(kw, debug_checks=False)),
                init_image=bad, callback=events.append)
    assert not np.isfinite(events[-1].losses["loss"]).any()


@pytest.mark.parametrize("optimizer, avg_decay", [("adam", 0.0), ("lbfgs", 0.0), ("lbfgs", 0.9)])
def test_resume_reproduces_the_run_bit_for_bit(packages, images, tmp_path, optimizer, avg_decay):
    """A two-scale run resumed mid-scale from a chunk's ``get_state()``, and
    at the next scale from a ``CheckpointManager`` on disk, ends on the
    uninterrupted run's bits."""
    kw = _small(size=32, min_scale=16, iterations=(4,), chunk_size=2, avg_decay=avg_decay)
    pev, full, _, _ = _run(packages, images, optimizer, jax_side=False, **kw)
    _, resumed, _, _ = _run(packages, images, optimizer, jax_side=False,
                            resume_state=pev[0].get_state(), **kw)
    np.testing.assert_array_equal(resumed, full)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2, keep=50)
    for ev in pev[:-1]:
        mgr.save(ev.get_state(), ev.scale_index * 4 + ev.iteration)
    latest = mgr.latest()
    assert int(latest["scale_index"]) == 1 and int(latest["iteration"]) == 2
    assert ("ema" in latest) == (avg_decay > 0)
    _, resumed, _, _ = _run(packages, images, optimizer, jax_side=False, resume_state=latest,
                            callback=False, **kw)
    np.testing.assert_array_equal(resumed, full)


def test_get_state_holds_its_chunk(packages, images):
    """``get_state`` called after the run returns the state of its own chunk
    (the loop writes no tensor in place): resuming from the first event's
    state, fetched at the end, still reproduces the run."""
    kw = _small(size=32, min_scale=16, iterations=(4,), chunk_size=2)
    snapshots = []
    _, pst = packages
    content, style = images
    events = []
    full = pst.stylize(content, style, StylizeConfig(optimizer=OptimizerSpec("lbfgs"), **kw),
                       callback=fanout(events.append, None,
                                       lambda ev: snapshots.append(ev.get_state())))
    for ev, snap in zip(events, snapshots):
        late = ev.get_state()
        np.testing.assert_array_equal(late["image"], snap["image"])
        for a, b in zip(late["opt_state_leaves"], snap["opt_state_leaves"]):
            np.testing.assert_array_equal(a, b)
    resumed = pst.stylize(content, style, StylizeConfig(optimizer=OptimizerSpec("lbfgs"), **kw),
                          resume_state=events[0].get_state())
    np.testing.assert_array_equal(resumed, full)


def test_jax_adam_state_resumes_the_port(packages, images):
    """Adam's three leaves carry over too: the JAX package's state after its
    first chunk resumes the port, and the next losses agree."""
    kw = dict(size=64, min_scale=32, iterations=(3,), chunk_size=1)
    _, _, jev, _ = _run(packages, images, "adam", **kw)
    pev, _, jev2, _ = _run(packages, images, "adam", resume_state=jev[0].get_state(), **kw)
    _same_events(pev, jev2)


def test_resume_rejects_bad_state(packages, images):
    """The reference's errors: a scale beyond the plan, an image of another
    shape, optimizer leaves of another count or shape."""
    _, pst = packages
    content, style = images
    cfg = StylizeConfig(**_small(iterations=(4,), chunk_size=2))
    bad = {"scale_index": np.asarray(99), "iteration": np.asarray(0),
           "image": np.zeros((1, 32, 32, 3), np.float32), "opt_state_leaves": []}
    with pytest.raises(ValueError, match="scale"):
        pst.stylize(content, style, cfg, resume_state=bad)
    events = []
    pst.stylize(content, style, cfg, callback=events.append)
    good = events[0].get_state()
    with pytest.raises(ValueError, match="does not match"):
        pst.stylize(content, style, cfg, resume_state=dict(good, image=bad["image"]))
    with pytest.raises(ValueError, match="leaves"):
        pst.stylize(content, style, cfg, resume_state=dict(
            good, opt_state_leaves=good["opt_state_leaves"][:-1]))
    leaves = list(good["opt_state_leaves"])
    leaves[1] = np.zeros((9, 9), np.float32)
    with pytest.raises(ValueError, match="shape"):
        pst.stylize(content, style, cfg, resume_state=dict(good, opt_state_leaves=leaves))


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_opt_state_flatten_restore_roundtrip(optimizer):
    x = torch.rand(1, 4, 6, 3)
    opt = OptimizerSpec(optimizer, memory_size=3).build()
    state = opt.init(x)
    leaves = flatten_opt_state(state)
    leaves = [l + 1 for l in leaves]  # distinct values, dtypes kept
    restored = restore_opt_state(state, leaves)
    for a, b in zip(flatten_opt_state(restored), leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # float64 leaves (a checkpoint written elsewhere) are cast to the template's dtypes
    restored = restore_opt_state(state, [np.asarray(l, np.float64) for l in leaves])
    assert [a.dtype for a in flatten_opt_state(restored)] == [l.dtype for l in leaves]


def test_checkpoint_manager_save_latest_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1, keep=2)
    assert mgr.latest() is None
    for step in [10, 20, 30]:
        mgr.save({"image": np.full((2, 2), step, np.float32), "iteration": np.asarray(step),
                  "opt_state_leaves": [np.asarray(step, np.int32), np.ones(3, np.float32) * step],
                  "empty": []}, step)
    latest = mgr.latest()
    assert int(latest["iteration"]) == 30 and latest["image"].dtype == np.float32
    assert [l.dtype for l in latest["opt_state_leaves"]] == [np.int32, np.float32]
    np.testing.assert_array_equal(latest["opt_state_leaves"][1], np.full(3, 30, np.float32))
    assert latest["empty"] == []
    assert sorted(mgr._list_steps()) == [20, 30]  # keep=2 pruned step_10
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_20", "step_30"]


def test_checkpoint_manager_callback_saves_on_boundaries_and_done(packages, images, tmp_path):
    _, pst = packages
    content, style = images
    mgr = CheckpointManager(str(tmp_path / "ck"), every=4, keep=50)
    pst.stylize(content, style, StylizeConfig(**_small(iterations=(6,), chunk_size=2)),
                callback=mgr.callback)
    # the first chunk (boundary 0), the boundary at 4, and done at 6
    assert sorted(mgr._list_steps()) == [2, 4, 6]
    assert int(mgr.latest()["iteration"]) == 6
