"""The port's public surface against the JAX package's, on the CPU in fp32.

The ``VGG`` module and its constants against JAX's ``VGG`` on JAX's fixture
(rtol 1e-4); ``make_conv_pair`` against JAX's for each ``(pool, gram)``
(the JAX kernel in interpret mode); ``resize_image`` for every method of
``jax.image.resize`` (1e-5); and the name coverage: every public top-level
name of each JAX module exists in its port counterpart, or is in
:data:`NOT_PORTED` with the reason. The coverage reads both packages'
sources by AST, importing neither.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.models import vgg as jvgg
from style_transfer_tpu.ops.pallas import conv_pair as JCP
from style_transfer_tpu.utils import imgio as jimgio
from style_transfer_tpu_torch import VGG, VGG19
from style_transfer_tpu_torch.models import vgg
from style_transfer_tpu_torch.models import weights
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.utils import imgio

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_vgg_constants_equal_jax():
    assert vgg.CONV_NAMES == jvgg.CONV_NAMES
    assert vgg.POOL_NAMES == jvgg.POOL_NAMES
    assert vgg.LAYER_NAMES == jvgg.LAYER_NAMES
    assert vgg.LAYER_CHANNELS == jvgg.LAYER_CHANNELS
    assert VGG19 is VGG


@pytest.mark.parametrize("cls", [VGG, VGG19])
def test_vgg_module_matches_jax(cls, tiny_params):
    jparams, _, _ = tiny_params
    layers = ["conv1_1", "pool2", "conv4_2", "conv5_1"]
    x = np.random.RandomState(0).randn(1, 48, 48, 3).astype(np.float32)
    want = jvgg.VGG(jparams)(jnp.asarray(x), layers)
    model = cls(weights.from_numpy_params(jparams))
    assert model.arch == "vgg19" and not list(model.parameters())
    assert len(list(model.buffers())) == 2 * len(vgg.CONV_NAMES)
    got = model(torch.from_numpy(x), layers)
    for name in layers:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4)


def test_vgg_module_buffers_move_and_take_no_gradient(tiny_params):
    params = weights.from_numpy_params(tiny_params[0])
    model = VGG({n: params[n] for n in vgg.conv_names("vgg16")}, pooling="max")
    assert model.arch == "vgg16" and model.pooling == "max"
    assert set(model.params) == set(vgg.conv_names("vgg16"))
    moved = model.to(torch.float64)
    assert moved.params["conv1_1"]["kernel"].dtype == torch.float64
    x = torch.rand(1, 16, 16, 3, dtype=torch.float64, requires_grad=True)
    moved(x, ["conv2_1"])["conv2_1"].sum().backward()
    assert x.grad is not None and moved.params["conv1_1"]["kernel"].grad is None


def test_vgg_random_is_the_numpy_draw():
    """``VGG.random`` draws from ``init_params`` (numpy), as
    ``weights.random_fixture`` does: conv1_1's kernel is the first draw."""
    model = VGG.random(3)
    want = np.random.RandomState(3).standard_normal((3, 3, 3, 64)) * np.sqrt(2.0 / 27)
    np.testing.assert_array_equal(model.params["conv1_1"]["kernel"].numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("gram", [False, True])
def test_make_conv_pair_matches_jax(pool, gram):
    r = np.random.RandomState(7)
    x = r.randn(1, 8, 12, 64).astype(np.float32) * 0.3
    ws = []
    for cin, cout in ((64, 128), (128, 128)):
        ws += [r.randn(3, 3, cin, cout).astype(np.float32) * 0.05,
               r.randn(cout).astype(np.float32) * 0.1]
    want = JCP.make_conv_pair(pool=pool, gram=gram)(jnp.asarray(x), *map(jnp.asarray, ws))
    got = CP.make_conv_pair(pool=pool, gram=gram)(torch.from_numpy(x),
                                                 *map(torch.from_numpy, ws))
    same = CP.conv_pair(torch.from_numpy(x), *map(torch.from_numpy, ws), pool=pool, gram=gram)
    want, got, same = (want, got, same) if gram else ((want,), (got,), (same,))
    assert len(got) == len(want)
    for g, w, s in zip(got, want, same):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
        assert torch.equal(g, s)


@pytest.mark.parametrize("method", imgio.METHODS)
def test_resize_every_method_matches_jax(method):
    x = np.random.RandomState(1).rand(1, 13, 17, 3).astype(np.float32)
    for size in [(29, 40), (6, 17)]:  # up; down with one axis unchanged
        want = np.asarray(jimgio.resize_image(jnp.asarray(x), size, method=method))
        got = imgio.resize_image(torch.from_numpy(x), size, method=method).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="lanczos5"):
        imgio.resize_image(torch.rand(1, 4, 4, 3), (2, 2), method="area")


# ---------------------------------------------------------------- name coverage

# A JAX module whose port counterpart is not the same path under
# style_transfer_tpu_torch/ (with ops/pallas -> ops/kernels): its counterparts.
COUNTERPARTS = {
    "api.py": ["api.py", "networks.py"],
    "ops/pallas/block1_packed.py": ["ops/kernels/block1.py"],
    "ops/pallas/vmem.py": ["ops/kernels/dispatch.py", "ops/kernels/conv_single.py"],
    "models/block1_s2d.py": [],
}

# (JAX module, public name) -> why the port has no such name
NOT_PORTED = {
    ("api.py", "TPU_MAX_TENSOR_ELEMENTS"): "the XLA:TPU 2^31-element compile ceiling",
    ("api.py", "resolution_ceiling_excess"): "checks that XLA:TPU ceiling",
    ("models/block1_s2d.py", "block1_s2d"): "an XLA-only block-1 variant the JAX package "
                                            "never dispatches",
    ("models/block1_s2d.py", "gram_from_blocked"): "a helper of that variant",
    ("ops/losses.py", "FLAT_PAD_LIMIT"): "the TPU compile ceiling of the flat Gram operand",
    ("ops/pallas/block1_packed.py", "fits_scoped_vmem"): "the TPU's 16 MiB scoped-VMEM gate",
    ("ops/pallas/gram.py", "TILE_M"): "the TPU kernel's row tile in VMEM",
    ("ops/pallas/vmem.py", "SCOPED_LIMIT"): "the TPU's scoped-VMEM budget",
    ("ops/pallas/vmem.py", "SUBLANE"): "the TPU's 16-row sublane tile",
    ("ops/pallas/vmem.py", "SINGLE_EFF_LIMIT"): "a scoped-VMEM limit of the singles",
    ("ops/pallas/vmem.py", "WIDE_MAX_SLICES"): "the port runs the W-sliced forms unsliced",
    ("ops/pallas/vmem.py", "block1_fits"): "a scoped-VMEM gate",
    ("ops/pallas/vmem.py", "conv_gram_fits"): "a scoped-VMEM gate",
    ("ops/pallas/vmem.py", "pair_fits"): "a scoped-VMEM gate",
    ("ops/pallas/vmem.py", "single_fits"): "a scoped-VMEM gate",
    ("ops/pallas/vmem.py", "pair_bwd_scoped_bytes"): "a scoped-VMEM model",
    ("ops/pallas/vmem.py", "single_bwd_scoped_bytes"): "a scoped-VMEM model",
    ("ops/pallas/vmem.py", "wide_owned"): "the TPU's slice widths (16-column tiles)",
    ("ops/pallas/vmem.py", "wide_slices"): "the TPU's slice-count rule",
    ("parallel/mesh.py", "constrain_spatial"): "a NamedSharding helper: the port places "
                                               "tensors with scatter_rows",
    ("parallel/mesh.py", "image_sharding"): "a NamedSharding helper",
    ("parallel/mesh.py", "image_spec"): "a PartitionSpec helper",
    ("parallel/mesh.py", "replicated"): "a NamedSharding helper: the port has replicate",
    ("schedule.py", "FUSED_GRIDS_W"): "the TPU kernels' sublane grid the ladder snaps to",
    ("schedule.py", "FUSED_GRID_H"): "the same grid",
    ("schedule.py", "SNAP_TOLERANCE"): "the same grid's snapping",
    ("schedule.py", "snap_to_fused_grid"): "the same grid's snapping",
}


def _public(path: Path) -> set:
    """Top-level public names of a module: functions, classes and assigned
    names, and for a package's ``__init__`` the names it imports."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _jax_modules():
    root = REPO / "style_transfer_tpu"
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _port_names(rel: str) -> set:
    paths = COUNTERPARTS.get(rel, [rel.replace("ops/pallas/", "ops/kernels/")])
    return set().union(*[_public(REPO / "style_transfer_tpu_torch" / p) for p in paths])


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_jax_name_is_in_the_port(rel):
    missing = sorted(_public(REPO / "style_transfer_tpu" / rel) - _port_names(rel)
                     - {name for (mod, name) in NOT_PORTED if mod == rel})
    assert not missing, f"{rel}: not in the port and not in NOT_PORTED: {missing}"


def test_not_ported_list_names_only_missing_jax_names():
    for (rel, name), reason in NOT_PORTED.items():
        assert reason
        assert name in _public(REPO / "style_transfer_tpu" / rel), (rel, name)
        assert name not in _port_names(rel), f"{rel}: {name} is in the port now"
