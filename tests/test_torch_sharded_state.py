"""The mesh's sharded state (``style_transfer_tpu_torch/parallel/mesh.py``):
under ``StyleTransfer(mesh=...)`` the image, its gradient, Adam's moments,
the EMA, every image-sized L-BFGS and line-search leaf and the pipelined
records live split by rows over the mesh, as the JAX package shards them,
and TV runs per shard (``ops.kernels.epilogue.make_sharded_tv_loss``).

Meshes here repeat the CPU (``make_mesh(devices=["cpu"] * n)``), the
counterpart of the JAX tests' forced CPU devices; every shard runs the
kernels' plain versions, in fp32. Shard counts 2, 3 and 8 cut a 64-row image
at ``row_bounds`` into 32 + 32, 32 + 16 + 16 and 4 x 16 rows, and a 135-row
one into 64 + 71, 48 + 48 + 39 and 7 x 16 + 23.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.ops.pallas import epilogue as JE
from style_transfer_tpu.parallel import mesh as jmesh
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch import optim
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.ops.kernels import epilogue as EP
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.utils.ckpt import (
    CheckpointManager,
    flatten_opt_state,
    restore_opt_state,
)

torch.set_num_threads(2)

SHARDS = (2, 3, 8)


def cpu_mesh(n):
    return M.make_mesh(devices=["cpu"] * n)


# ------------------------------------------------------------- sharded TV


@pytest.fixture(scope="module")
def jax_tv():
    """The JAX ``make_sharded_tv_loss`` on its forced 8-device CPU mesh (as
    ``tests/test_sharding.py`` runs it) at a 64-row image: value and the
    gradient of 3.5 x the loss."""
    assert len(jax.devices()) == 8, "conftest must force 8 fake CPU devices"
    mesh8 = jmesh.make_mesh()
    img = np.random.RandomState(3).rand(1, 64, 48, 3).astype(np.float32)
    tv = JE.make_sharded_tv_loss(mesh8, jmesh.SPATIAL_AXIS)
    sharded = jmesh.shard_image(jnp.asarray(img), mesh8)
    val = float(jax.jit(tv)(sharded))
    grad = np.asarray(jax.jit(jax.grad(lambda im: 3.5 * tv(im)))(sharded))
    return img, val, grad


def _port_tv(img, rows, fused=True):
    """The port's sharded TV of ``img`` cut into shards of ``rows`` rows:
    the value and the gathered gradient of 3.5 x the loss, and the shards'
    gradients."""
    mesh = cpu_mesh(len(rows))
    shards = M.shard_rows(torch.from_numpy(img), rows, mesh.devices)
    for s in shards:
        s.requires_grad_(True)
    val = EP.make_sharded_tv_loss(mesh, fused=fused)(shards)
    grads = torch.autograd.grad(3.5 * val, shards)
    return float(val.detach()), M.gather_rows(grads, "cpu").numpy(), grads


@pytest.mark.parametrize("rows", [[8] * 8, [32, 32], [32, 16, 16], [16] * 4, [1, 62, 1]],
                         ids=["jax_layout", "n2", "n3", "n8", "one_row_edges"])
def test_sharded_tv_matches_the_jax_mesh_form(jax_tv, rows):
    """Against JAX's ``make_sharded_tv_loss`` on the 8-device mesh: value
    at rtol 1e-6, gradient at rtol 1e-5 and atol 1e-7 (the JAX test's own
    limits), on JAX's layout (8 rows a device) and on ``row_bounds``'s."""
    img, jval, jgrad = jax_tv
    val, grad, _ = _port_tv(img, rows)
    np.testing.assert_allclose(val, jval, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("fused", [True, False])
def test_sharded_tv_matches_the_unsharded_tv(n, fused):
    """An image of 135 rows, cut unevenly at ``row_bounds``: the sharded TV
    against the port's unsharded ``tv_loss`` and JAX's ``losses.tv_loss``,
    at the JAX test's limits; each shard's gradient lies on its own rows."""
    img = np.random.RandomState(n).rand(1, 135, 40, 3).astype(np.float32)
    rows = [hi - lo for lo, hi in M.row_bounds(135, n)]
    val, grad, grads = _port_tv(img, rows, fused)
    assert [int(g.shape[1]) for g in grads] == rows
    x = torch.from_numpy(img).requires_grad_(True)
    ref = EP.tv_loss(x)
    (ref_grad,) = torch.autograd.grad(3.5 * ref, x)
    jval = float(JL.tv_loss(jnp.asarray(img)))
    jgrad = np.asarray(jax.grad(lambda im: 3.5 * JL.tv_loss(im))(jnp.asarray(img)))
    for want_val, want_grad in ((float(ref.detach()), ref_grad.numpy()), (jval, jgrad)):
        np.testing.assert_allclose(val, want_val, rtol=1e-6)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-7)


def test_sharded_tv_of_one_shard_is_tv_loss():
    img = torch.rand(1, 20, 9, 3)
    assert torch.equal(EP.make_sharded_tv_loss(cpu_mesh(1))([img]), EP.tv_loss(img))
    assert torch.equal(L.tv_loss(img), L.tv_sse(img) / float(img.numel()))


# ------------------------------------------------------------------ stylize


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    return jparams, from_numpy_params(jparams), mean, std


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(42)
    return r.rand(64, 48, 3).astype(np.float32), r.rand(48, 64, 3).astype(np.float32)


ADAM = dict(size=64, min_scale=32, iterations=(4,), chunk_size=2, avg_decay=0.9, init="random",
            optimizer=OptimizerSpec("adam", learning_rate=0.05))
LBFGS = dict(size=64, min_scale=64, iterations=(4,), chunk_size=2, tv_weight=8.0,
             optimizer=OptimizerSpec("lbfgs", memory_size=3))


def _storage_bytes(t):
    return t.untyped_storage().nbytes()


class _Walk:
    """Spies on ``StyleTransfer._dispatch_chunk`` and on the optimizers'
    updates; :meth:`check` walks each record's image-sized tensors (the
    image, the EMA, the display image, every image-sized optimizer leaf) and
    the gradients the updates saw."""

    def __init__(self, st, monkeypatch):
        self.records, self.grads = [], []
        real = st._dispatch_chunk

        def dispatch(*a, **kw):
            rec = real(*a, **kw)
            self.records.append(rec)
            return rec

        st._dispatch_chunk = dispatch
        for cls in (optim.Adam, optim.LBFGS):
            monkeypatch.setattr(cls, "update", self._spy(cls.update))

    def _spy(self, update):
        def spied(opt, grad, *a, **kw):
            self.grads.append(grad)
            return update(opt, grad, *a, **kw)

        return spied

    def check(self, mesh):
        """Every image-sized tensor of every record, and every gradient, is
        a tuple of shards with its shard's rows and device, each its own
        storage (no view of a full-size buffer); the scalar leaves lie on
        the home device. Returns the count of sharded tensors walked."""
        walked = 0

        def sharded(x, h, w):
            nonlocal walked
            bounds = M.row_bounds(h, mesh.size)
            assert isinstance(x, tuple) and len(x) == len(bounds)
            for s, (lo, hi), dev in zip(x, bounds, mesh.devices):
                ax = M.row_axis(s)
                assert s.device == dev and s.shape[ax] == hi - lo and s.shape[ax + 1] == w
                assert _storage_bytes(s) == s.numel() * s.element_size()
            walked += 1

        def hw(image):
            return sum(int(s.shape[1]) for s in image), int(image[0].shape[2])

        for rec in self.records:
            for t in (rec.image, rec.ema, rec.snap):
                if t is not None:
                    sharded(t, *hw(rec.image))
            for leaf in optim.state_leaves(rec.opt_state):
                if isinstance(leaf, torch.Tensor):
                    assert leaf.device == mesh.home and leaf.dim() <= 1
                elif isinstance(leaf, tuple):
                    sharded(leaf, *hw(rec.image))
        for g in self.grads:
            sharded(g, *hw(g))
        return walked


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
def test_state_lives_on_the_shards(packages, images, monkeypatch, n, kind):
    """Adam with the EMA over 32 -> 64 rows (a resize between the scales)
    and L-BFGS: every image-sized tensor of every pipelined record and
    every gradient is split by rows over the mesh."""
    _, pparams, mean, std = packages
    content, style = images
    mesh = cpu_mesh(n)
    st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=mesh)
    walk = _Walk(st, monkeypatch)
    cfg = StylizeConfig(**(ADAM if kind == "adam" else LBFGS))
    out = st.stylize(content, style, cfg, callback=lambda e: e.get_image())
    assert out.shape == (64, 48, 3) and np.isfinite(out).all()
    # records: image, EMA, display image and Adam's mu, nu; or image, display
    # image and L-BFGS's five image-sized leaves (params, updates, the two
    # rings, the line search's grad)
    per_record = 5 if kind == "adam" else 7
    assert walk.check(mesh) == per_record * len(walk.records) + len(walk.grads)
    assert len(walk.grads) > 0


def _events(st, content, style, cfg):
    ev = []
    out = st.stylize(content, style, cfg, callback=ev.append)
    return out, ev


@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
def test_stylize_on_the_mesh_matches_no_mesh(packages, images, kind):
    """Three shards (32 + 16 + 16 rows at 64) against no mesh, fp32: every
    step's loss terms within 1e-5 relative, for Adam with the EMA over two
    scales and for L-BFGS (post-step pixels are not compared: ROADMAP.md)."""
    _, pparams, mean, std = packages
    content, style = images
    cfg = StylizeConfig(**(ADAM if kind == "adam" else LBFGS))
    runs = {}
    for name, mesh in (("one", None), ("mesh", cpu_mesh(3))):
        st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=mesh)
        runs[name] = _events(st, content, style, cfg)
    (out1, ev1), (out3, ev3) = runs["one"], runs["mesh"]
    assert [e.shards for e in ev3] == ([2, 2, 3, 3] if kind == "adam" else [3, 3])
    for k in ("loss", "content", "style", "tv"):
        a = np.concatenate([e.losses[k] for e in ev3])
        b = np.concatenate([e.losses[k] for e in ev1])
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
    assert out3.shape == out1.shape and np.isfinite(out3).all()


@pytest.fixture(scope="module")
def jax_mesh_objective(packages, images):
    """JAX's ``StyleTransfer(mesh=make_mesh(8))`` objective (its plain-XLA
    one, partitioned by XLA) at one image: the terms and the gradient."""
    jparams, _, mean, std = packages
    content, style = images
    image = np.clip(content + 0.05 * np.random.RandomState(5).randn(*content.shape),
                    0, 1).astype(np.float32)[None]
    jst = JStyleTransfer(jparams, mean=mean, std=std, mesh=jmesh.make_mesh(8))
    jcfg = JStylizeConfig(size=(64, 48), use_fused=False)
    cw = JL.normalize_layer_weights(jcfg.content_layers)
    sw = JL.normalize_layer_weights(jcfg.style_layers)
    layers = tuple(dict.fromkeys(list(jcfg.content_layers) + list(jcfg.style_layers)))
    feats = jax.jit(lambda p, x, ls: jst._features(p, x, ls), static_argnums=2)
    c_t = feats(jst.params, jnp.asarray(content)[None], jcfg.content_layers)
    s_t = {k: JL.gram_matrix(v) for k, v in
           feats(jst.params, jnp.asarray(style)[None], jcfg.style_layers).items()}
    objective = jst._build_objective(
        jcfg, c_weights=cw, s_weights=sw, all_layers=layers, gram_fn=JL.gram_matrix,
        loss_fns={}, fused_b1=False, packed_b1=False, packed_b2=False, packed_b3=False,
        packed_b4=False)
    (_, jterms), jgrad = jax.jit(jax.value_and_grad(
        lambda im: objective(jst.params, im, c_t, s_t), has_aux=True))(
        jmesh.shard_image(jnp.asarray(image), jst.mesh))
    return image, {k: float(v) for k, v in jterms.items()}, np.asarray(jgrad)


@pytest.mark.parametrize("use_fused", [True, False])
def test_first_evaluation_on_shards_matches_the_jax_mesh(packages, images, jax_mesh_objective,
                                                         use_fused):
    """The objective fed the image's row shards (as the optimize loop holds
    it) on 8 CPU shards against JAX's ``StyleTransfer(mesh=make_mesh(8))``:
    loss terms at rtol 1e-4 and the gathered gradient at 1e-4 relative
    Frobenius; the TV term is the sharded one."""
    _, pparams, mean, std = packages
    content, style = images
    image, jterms, jg = jax_mesh_objective
    mesh = cpu_mesh(8)
    st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=mesh)
    cfg = StylizeConfig(size=(64, 48), use_fused=use_fused)
    c = st._capture_content(cfg, torch.from_numpy(content)[None])
    s = st._capture_style(cfg, torch.from_numpy(style)[None])
    xs = M.shard_image(torch.from_numpy(image), mesh)
    for x in xs:
        x.requires_grad_(True)
    loss, terms = st._build_objective(cfg)(xs, c, s)
    grads = torch.autograd.grad(loss, xs)
    assert [int(g.shape[1]) for g in grads] == [16] * 4
    for k in ("loss", "content", "style", "tv"):
        np.testing.assert_allclose(float(terms[k].detach()), jterms[k], rtol=1e-4)
    grad = M.gather_rows(grads, "cpu").numpy()
    assert np.linalg.norm(grad - jg) / np.linalg.norm(jg) < 1e-4


# ------------------------------------------------------------------- resume


def _run_keeping_first_state(st, content, style, cfg):
    """The events of a run, and ``get_state()`` of its first event."""
    events, states = [], []

    def keep(event):
        if not states:
            states.append(event.get_state())
        events.append(event)

    st.stylize(content, style, cfg, callback=keep)
    return events, states[0]


@pytest.mark.parametrize("kind", ["adam", "lbfgs"])
def test_checkpoint_crosses_mesh_and_no_mesh(packages, images, tmp_path, kind):
    """A checkpoint taken on the mesh has the unsharded leaf shapes (a
    ``CheckpointManager`` round trip included), restores onto a state
    without a mesh, and one taken without a mesh onto a mesh's shards, each
    with the leaves equal bit for bit; both resume through ``stylize`` and
    continue as the uninterrupted run of the other placement does (the next
    chunk's loss terms within 1e-5)."""
    _, pparams, mean, std = packages
    content, style = images
    cfg = StylizeConfig(**dict(ADAM if kind == "adam" else LBFGS, min_scale=64))
    mesh = cpu_mesh(3)
    sts = {"mesh": StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=mesh),
           "one": StyleTransfer(pparams, mean=mean, std=std, device="cpu")}
    runs = {k: _run_keeping_first_state(st, content, style, cfg) for k, st in sts.items()}
    states = {k: v[1] for k, v in runs.items()}

    ck = CheckpointManager(str(tmp_path / "ck"), every=1)
    ck.save(states["mesh"], 2)
    saved = ck.latest()
    for k in ("image", "ema") if kind == "adam" else ("image",):
        assert saved[k].shape == states["one"][k].shape == (1, 64, 48, 3)
    assert ([np.shape(l) for l in saved["opt_state_leaves"]]
            == [np.shape(l) for l in states["one"]["opt_state_leaves"]])

    opt = cfg.optimizer.build()
    image = torch.zeros(1, 64, 48, 3)
    for src, template in (("mesh", image), ("one", M.shard_image(image, mesh))):
        leaves = states[src]["opt_state_leaves"]
        back = flatten_opt_state(restore_opt_state(opt.init(template), leaves))
        assert all(np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype
                   for a, b in zip(back, leaves))
    restored = sts["mesh"]._state_image(states["one"]["image"])
    assert np.array_equal(M.gather_rows(restored, "cpu").numpy(), states["one"]["image"])

    for src, dst in (("mesh", "one"), ("one", "mesh")):
        resumed = []
        sts[dst].stylize(content, style, cfg, callback=resumed.append,
                         resume_state=states[src])
        whole = runs[src][0]
        for k in ("loss", "content", "style", "tv"):
            np.testing.assert_allclose(resumed[0].losses[k], whole[1].losses[k], rtol=1e-5,
                                       err_msg=f"{src} -> {dst}: {k}")
