"""The port's step entry (``style_transfer_tpu_torch.entry``) against
``__graft_entry__._build_step`` on the CPU: the JAX step at 64x64 in fp32
with ``use_fused=True`` (the Pallas Gram off the TPU, as the JAX tests run
it), and the port's ``build_step`` on the same images. The targets, the
first step's loss and the image gradient (read from Adam's first moment,
which is ``(1 - b1) g`` after one step) agree at rtol 1e-4 (the gradient
as a relative Frobenius error), and so do the losses of the next two steps;
post-Adam pixels are not compared. With these random weights the loss does
not fall from the first step: Adam's first step (every pixel moved by the
learning rate) overshoots, in the reference's step as in the port's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu_torch import entry as E
from style_transfer_tpu_torch import optim
from style_transfer_tpu_torch.models.weights import from_numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B1 = 0.9

torch.set_num_threads(2)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def reference():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.remove(REPO)
    from style_transfer_tpu.models.weights import random_fixture

    params, mean, std = random_fixture(0)
    step, (p, image, state, c_t, s_t) = g._build_step(
        params, mean, std, (64, 64), compute_dtype=jnp.float32, use_fused=True)
    run = jax.jit(step)
    img, state1, loss = run(p, image, state, c_t, s_t)
    st, losses = state1, []
    for _ in range(2):
        img, st, l = run(p, img, st, c_t, s_t)
        losses.append(float(l))
    # the draws of _build_step (__graft_entry__.py:55-58)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    images = [np.array(jax.random.uniform(k, (1, 64, 64, 3), jnp.float32)) for k in (k1, k2)]
    return {"params": params, "mean": mean, "std": std, "images": images + [np.array(image)],
            "c_t": {k: np.array(v) for k, v in c_t.items()},
            "s_t": {k: np.array(v) for k, v in s_t.items()},
            "loss": float(loss), "losses": losses,
            "mu": np.array(jax.tree_util.tree_leaves(state1)[1])}


def test_build_step_matches_the_reference(reference):
    r = reference
    step, (p, image, state, c_t, s_t) = E.build_step(
        from_numpy_params(r["params"]), r["mean"], r["std"], (64, 64), device="cpu",
        compute_dtype=torch.float32, images=r["images"])
    assert np.array_equal(image.numpy(), r["images"][2])
    for layer, target in {**r["c_t"], **r["s_t"]}.items():
        got = (c_t.get(layer) if layer in c_t else s_t[layer]).numpy()
        assert _rel(got, target) <= 1e-4, layer
    # the reference's own image and targets through the port's step
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    img = torch.from_numpy(r["images"][2])
    img, state1, loss = step(p, img, state, to_t(r["c_t"]), to_t(r["s_t"]))
    assert float(loss) == pytest.approx(r["loss"], rel=1e-4)
    count, mu, _ = optim.state_leaves(state1)
    assert count == 1
    assert _rel(mu.numpy() / (1 - B1), r["mu"] / (1 - B1)) <= 1e-4
    losses, state = [], state1
    for _ in range(2):
        img, state, loss = step(p, img, state, to_t(r["c_t"]), to_t(r["s_t"]))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-4)


def test_build_step_draws_the_same_images():
    from style_transfer_tpu_torch.models.weights import random_fixture

    params, mean, std = random_fixture(0)
    (step, args), (_, again) = [E.build_step(params, mean, std, (32, 32), device="cpu")
                                for _ in range(2)]
    assert torch.equal(args[1], again[1])
    p, image, state, c_t, s_t = args
    losses = []
    for _ in range(3):
        image, state, loss = step(p, image, state, c_t, s_t)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    plain_step, plain = E.build_step(params, mean, std, (32, 32), device="cpu", use_fused=False)
    assert float(plain_step(*plain)[2]) == pytest.approx(float(step(*args)[2]), rel=1e-6)


def test_build_step_refuses_wrong_shapes():
    from style_transfer_tpu_torch.models.weights import random_fixture

    params, mean, std = random_fixture(0)
    images = [np.zeros((1, 32, 32, 3), np.float32)] * 2 + [np.zeros((1, 32, 16, 3), np.float32)]
    with pytest.raises(ValueError, match="image has shape"):
        E.build_step(params, mean, std, (32, 32), device="cpu", images=images)


def test_entry_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        E.entry()


def test_dryrun_multichip_delegates(monkeypatch):
    from style_transfer_tpu_torch.parallel import dryrun

    calls = []
    monkeypatch.setattr(dryrun, "dryrun_multichip", lambda *a: calls.append(a) or ["ok"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert E.dryrun_multichip(8) == ["ok"]
    assert calls[-1] == (8, ["cuda:0"] * 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    E.dryrun_multichip(8)
    assert calls[-1] == (8, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        E.dryrun_multichip(2)
