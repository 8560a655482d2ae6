"""The port's spatial mesh (``style_transfer_tpu_torch/parallel``): the mesh
helpers, the sharded plain VGG, and the mesh through ``StyleTransfer``,
``stylize()`` and the command line, against the port without a mesh and
against the JAX package's mesh on its forced 8-device CPU mesh.

Meshes here are lists of CPU devices (``make_mesh(devices=["cpu"] * n)``),
the counterpart of the JAX tests' forced CPU devices; every shard runs the
kernels' plain versions. Post-Adam pixels are not compared (ROADMAP.md:
near-zero gradients flip sign under Adam); losses and gradients are.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.api import StyleTransfer as JStyleTransfer
from style_transfer_tpu.api import StylizeConfig as JStylizeConfig
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.parallel import mesh as jmesh
from style_transfer_tpu_torch import StyleTransfer, StylizeConfig, api, cli
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.models.weights import from_numpy_params
from style_transfer_tpu_torch.optim import OptimizerSpec
from style_transfer_tpu_torch.parallel import dryrun
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)


def cpu_mesh(n):
    return M.make_mesh(devices=["cpu"] * n)


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("h, n, want", [
    (2160, 8, [272] * 7 + [256]),
    (135, 8, [16] * 7 + [23]),  # the rows past the last grain lengthen the last shard
    (64, 8, [16] * 4),  # one shard per 16 rows at most
    (50, 3, [16, 16, 18]),
    (10, 4, [10]),  # below one grain: one shard
    (48, 1, [48]),
])
def test_row_bounds(h, n, want):
    bounds = M.row_bounds(h, n)
    assert [hi - lo for lo, hi in bounds] == want
    assert bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % M.ROW_GRAIN == 0 for lo, _ in bounds)  # even at every pool before conv5_1
    assert M.shard_count(h, n) == len(bounds)


def test_make_mesh():
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.home == torch.device("cpu")
    assert mesh.distinct() == (torch.device("cpu"),)
    assert mesh.take(2).devices == mesh.devices[:2]
    assert mesh.axis_names == (M.SPATIAL_AXIS,) == ("space",)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"asked for 99 devices, have {have}"):
        M.make_mesh(99)


def test_pixels_per_device():
    """A repeated device holds all of its shards' pixels."""
    bounds = M.row_bounds(64, 4)
    assert M.pixels_per_device(bounds, 10, cpu_mesh(4)) == 640
    mixed = M.make_mesh(devices=["cpu", "meta", "cpu", "meta"])
    assert M.pixels_per_device(bounds, 10, mixed) == 320


def test_replica_is_made_once_per_device():
    t = torch.arange(6.0)
    assert M.replica(t, torch.device("cpu")) is t
    a = M.replica(t, torch.device("meta"))
    assert a.device.type == "meta" and M.replica(t, torch.device("meta")) is a
    rep = M.replicate({"conv1_1": {"kernel": t}}, M.make_mesh(devices=["cpu", "meta", "cpu"]))
    assert set(rep) == {torch.device("cpu"), torch.device("meta")}
    assert rep[torch.device("cpu")]["conv1_1"]["kernel"] is t
    assert rep[torch.device("meta")]["conv1_1"]["kernel"] is a


@pytest.mark.parametrize("rows, up, down", [
    ((4, 4, 4), 1, 1), ((4, 5, 7), 2, 1), ((2, 2, 3), 2, 2), ((3, 6), 0, 1), ((16, 18), 2, 2)])
def test_with_halo_gradcheck(rows, up, down):
    """The halo exchange's backward against finite differences in float64:
    a halo row's cotangent goes back to its owner, also where a shard's two
    halo spans overlap (2 rows, 2 each way)."""
    rng = np.random.RandomState(sum(rows))
    shards = [torch.tensor(rng.randn(1, r, 3, 2), dtype=torch.float64, requires_grad=True)
              for r in rows]
    assert torch.autograd.gradcheck(lambda *s: tuple(M.with_halo(list(s), up, down)), shards)
    ext = M.with_halo(shards, up, down)
    full = torch.cat(shards, dim=1)
    starts = np.cumsum((0,) + rows)
    for i, e in enumerate(ext):  # the rows themselves, no halo beyond the edges
        lo = starts[i] - (up if i else 0)
        hi = starts[i + 1] + (down if i < len(rows) - 1 else 0)
        torch.testing.assert_close(e, full[:, lo:hi], rtol=0, atol=0)


def test_with_halo_sums_bf16_cotangents_once():
    """A row of the middle shard of 2 rows, halos 2 each way, gets three
    partial cotangents: 1 + 2^-8 + 2^-8 in fp32 is 1 + 2^-7, a bf16 value;
    bf16 adds in turn would round 1 + 2^-8 to 1 twice."""
    bf = torch.bfloat16
    shards = [torch.zeros(1, 2, 1, 1, dtype=bf, requires_grad=True) for _ in range(3)]
    ext = M.with_halo(shards, 2, 2)
    grads = [torch.full_like(e, 2.0 ** -8) for e in ext]
    grads[1] = torch.ones_like(ext[1])
    (g,) = torch.autograd.grad(ext, [shards[1]], grads)
    assert g.dtype == bf and torch.all(g == 1 + 2.0 ** -7)
    sequential = (torch.ones((), dtype=bf) + torch.tensor(2.0 ** -8, dtype=bf)) + torch.tensor(
        2.0 ** -8, dtype=bf)
    assert float(sequential) == 1.0


def test_with_halo_needs_enough_rows():
    shards = [torch.zeros(1, r, 2, 1) for r in (4, 1, 4)]
    with pytest.raises(ValueError, match="fewer than the 2-row halo"):
        M.with_halo(shards, 2, 2)


def test_scatter_gather_and_all_reduce():
    x = torch.randn(1, 40, 3, 2, dtype=torch.float64, requires_grad=True)
    mesh = cpu_mesh(2)
    bounds = M.row_bounds(40, 2)
    assert torch.autograd.gradcheck(
        lambda x: M.gather_rows(M.scatter_rows(x, bounds, mesh), "cpu"), (x,))
    parts = [torch.randn(3, 3, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(lambda *p: M.all_reduce_to(p, "cpu"), parts)


# ------------------------------------------------------- sharded plain VGG


@pytest.mark.parametrize("pooling", ["average", "max"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_extract_features_sharded(n, pooling):
    """Every layer through pool5, on 134 rows (odd extents at the deep
    levels, shards starting on odd rows at conv5_1's level), in float64:
    the shards' activations and the input gradient equal the unsharded
    forward's."""
    params = {k: {n_: t.double() for n_, t in p.items()}
              for k, p in vgg.init_params(0).items()}
    x = torch.tensor(np.random.RandomState(n).randn(1, 134, 12, 3), requires_grad=True)
    layers = ("conv1_1", "conv3_1", "conv4_2", "pool4", "conv5_1", "pool5")
    want = vgg.extract_features(params, x, layers, pooling=pooling)
    mesh = cpu_mesh(n)
    xs = M.scatter_rows(x, M.row_bounds(134, n), mesh)
    got = vgg.extract_features_sharded(params, xs, layers, pooling=pooling)
    for l in layers:
        torch.testing.assert_close(M.gather_rows(got[l], "cpu"), want[l], rtol=1e-10, atol=1e-12)
    weights = [torch.randn_like(want[l]) for l in layers]
    (g1,) = torch.autograd.grad(sum((want[l] * c).sum() for l, c in zip(layers, weights)), x)
    (g2,) = torch.autograd.grad(
        sum((M.gather_rows(got[l], "cpu") * c).sum() for l, c in zip(layers, weights)), x)
    torch.testing.assert_close(g2, g1, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------- the API


@pytest.fixture(scope="module")
def packages(tiny_params):
    jparams, mean, std = tiny_params
    return jparams, from_numpy_params(jparams), mean, std


@pytest.fixture(scope="module")
def images():
    r = np.random.RandomState(42)
    return r.rand(64, 48, 3).astype(np.float32), r.rand(48, 64, 3).astype(np.float32)


def _port_objective(st, cfg, content, style, image):
    c = st._capture_content(cfg, torch.from_numpy(content)[None])
    s = st._capture_style(cfg, torch.from_numpy(style)[None])
    x = torch.from_numpy(image).requires_grad_(True)
    loss, terms = st._build_objective(cfg)(x, c, s)
    (grad,) = torch.autograd.grad(loss, x)
    return {k: float(v.detach()) for k, v in terms.items()}, grad.numpy(), st.last_route


@pytest.mark.parametrize("use_fused", [True, False])
def test_mesh_objective_matches_jax_mesh(packages, images, use_fused):
    """The port's objective on 8 CPU shards (4 used at 64 rows) against
    JAX's ``StyleTransfer(mesh=make_mesh(8))`` (its plain-XLA objective,
    partitioned by XLA): loss terms and image gradient at rtol 1e-4
    (relative Frobenius for the gradient)."""
    jparams, pparams, mean, std = packages
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

    pst = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=cpu_mesh(8))
    terms, grad, route = _port_objective(pst, StylizeConfig(size=(64, 48), use_fused=use_fused),
                                         content, style, image)
    if use_fused:
        assert dict(route)["conv5_1"] == "conv_gram"
    else:
        assert route == (("vgg", "plain_sharded"),)
    for k in ("loss", "content", "style", "tv"):
        np.testing.assert_allclose(terms[k], float(jterms[k]), rtol=1e-4)
    jg = np.asarray(jgrad)
    assert np.linalg.norm(grad - jg) / np.linalg.norm(jg) < 1e-4


@pytest.mark.parametrize("variant", ["pairs", "singles", "gram_tail", "natural"])
def test_dryrun_multichip_on_cpu_shards(variant, monkeypatch):
    """``parallel.dryrun``'s four variants on 8 CPU shards in float64 (the
    natural variant with the size rule's limit lowered to 64 px, so a 64 px
    wide image takes the singles unforced)."""
    from style_transfer_tpu_torch.ops.kernels import dispatch

    if variant == "natural":
        monkeypatch.setattr(dispatch, "PAIR_EFF_LIMIT", 64)
    (res,) = dryrun.dryrun_multichip(8, ["cpu"] * 8, variants=(variant,))
    assert res["shards"] == 8 and res["grad_rel"] < dryrun.CPU_TOL["grad"]


def _losses(events):
    return np.concatenate([e.losses["loss"] for e in events])


def test_stylize_on_the_mesh_matches_no_mesh(packages, images):
    """Two scales (32 -> 64 rows: two shards, then four), three Adam steps
    each: the per-step losses within 1e-3 of the port without a mesh, and
    each event names its shard count. ``fused_block1`` is ignored under a
    mesh: the chain runs."""
    _, pparams, mean, std = packages
    content, style = images
    cfg = StylizeConfig(size=64, min_scale=32, iterations=(3,), chunk_size=3,
                        optimizer=OptimizerSpec("adam", learning_rate=0.05))
    runs = {}
    for name, mesh in (("one", None), ("mesh", cpu_mesh(8))):
        st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=mesh)
        ev = []
        out = st.stylize(content, style, cfg, callback=ev.append)
        runs[name] = ev
        assert out.shape == (64, 48, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(_losses(runs["mesh"]), _losses(runs["one"]), rtol=1e-3)
    assert [e.shards for e in runs["mesh"]] == [2, 4] and [e.shards for e in runs["one"]] == [1, 1]
    st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=cpu_mesh(8))
    st.stylize(content, style, StylizeConfig(size=64, min_scale=64, iterations=(1,),
                                             fused_block1=True))
    assert dict(st.last_route)["block1"] == "pair"


@pytest.mark.parametrize("use_fused", [True, False])
def test_remat_on_the_mesh_keeps_the_bits(images, use_fused):
    """``remat=True`` checkpoints each sharded kernel call (each sharded
    plain block) and recomputes it in the backward: the same losses, bit
    for bit."""
    content, style = images
    st = StyleTransfer(device="cpu", mesh=cpu_mesh(4))
    losses = []
    for remat in (False, True):
        ev = []
        st.stylize(content, style, StylizeConfig(size=64, min_scale=64, iterations=(2,),
                                                 remat=remat, use_fused=use_fused),
                   callback=ev.append)
        losses.append(_losses(ev))
    np.testing.assert_array_equal(losses[1], losses[0])


def test_lbfgs_and_resume_on_the_mesh(packages, images):
    """L-BFGS on the mesh follows the port without one (losses within 1e-3
    over one chunk), and a resume from the mesh's mid-run state ends on the
    uninterrupted mesh run's bits."""
    _, pparams, mean, std = packages
    content, style = images
    cfg = StylizeConfig(size=64, min_scale=64, iterations=(4,), chunk_size=2, tv_weight=8.0,
                        optimizer=OptimizerSpec("lbfgs", memory_size=5))
    st = StyleTransfer(pparams, mean=mean, std=std, device="cpu", mesh=cpu_mesh(4))
    ev, ev1 = [], []
    out = st.stylize(content, style, cfg, callback=ev.append)
    StyleTransfer(pparams, mean=mean, std=std, device="cpu").stylize(
        content, style, cfg, callback=ev1.append)
    np.testing.assert_allclose(ev[0].losses["loss"], ev1[0].losses["loss"], rtol=1e-3)
    again = st.stylize(content, style, cfg, resume_state=ev[0].get_state())
    np.testing.assert_array_equal(again, out)


# ------------------------------------------------------------ command line


def _pngs(tmp_path, images):
    content, style = images
    paths = [str(tmp_path / "c.png"), str(tmp_path / "s.png")]
    imgio.save_image(content, paths[0])
    imgio.save_image(style, paths[1])
    return paths


FAST = ["--size", "64", "--min-scale", "64", "--iterations", "4", "--chunk-size", "2",
        "--random-weights", "--device", "cpu", "--print-every", "100"]


def test_cli_cpu_shards_match_one_device(tmp_path, images, capsys):
    """``--device cpu --devices 4`` (a mesh of 4 CPU shards) against
    ``--devices 1``: the same losses at rtol 1e-4."""
    paths = _pngs(tmp_path, images)
    losses = {}
    for n in (1, 4):
        metrics = str(tmp_path / f"m{n}.json")
        assert cli.main(paths + ["-o", str(tmp_path / f"o{n}.png"), "--metrics-out", metrics,
                                 "--devices", str(n)] + FAST) == 0
        with open(metrics) as f:
            losses[n] = [r["loss"] for r in json.load(f)["records"]]
    assert "mesh: 4 devices" in capsys.readouterr().out
    np.testing.assert_allclose(losses[4], losses[1], rtol=1e-4)


class _Built(Exception):
    pass


@pytest.mark.parametrize("flags, visible, want", [
    ([], 2, ["cuda:0", "cuda:1"]),  # unset: all visible cards
    (["--devices", "2"], 4, ["cuda:0", "cuda:1"]),
    (["--devices", "1"], 4, None),
    ([], 1, None),
])
def test_cli_builds_the_mesh_on_the_card_route(tmp_path, images, monkeypatch, flags, visible,
                                               want):
    """The card route with ``visible`` cards (monkeypatched): the mesh the
    CLI hands to ``StyleTransfer``, as the JAX CLI builds it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = {}

    def fake(*a, mesh=None, **kw):
        seen["mesh"] = mesh
        raise _Built

    monkeypatch.setattr(api, "StyleTransfer", fake)
    with pytest.raises(_Built):
        cli.main(_pngs(tmp_path, images) + ["--random-weights"] + flags)
    got = seen["mesh"]
    assert (None if got is None else [str(d) for d in got.devices]) == want


def test_cli_devices_above_the_visible_count_exit_2(tmp_path, images, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.main(_pngs(tmp_path, images) + ["--random-weights", "--devices", "99"]) == 2
    assert "--devices 99: 2 CUDA device(s) visible" in capsys.readouterr().err


# ---------------------------------------------------------------- imports


def test_mesh_path_uses_no_torch_distributed():
    """The mesh is one process driving every device: nothing in the port
    imports or reaches ``torch.distributed``."""
    root = Path(__file__).resolve().parents[1] / "style_transfer_tpu_torch"
    found = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            elif (isinstance(node, ast.Attribute) and node.attr == "distributed"
                  and isinstance(node.value, ast.Name) and node.value.id == "torch"):
                names = ["torch.distributed"]
            found += [f"{path.name}:{node.lineno}" for n in names
                      if n.startswith("torch.distributed")]
    assert not found, found
