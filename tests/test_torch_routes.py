"""The networks' plans against the routes recorded before the planner existed.

``tests/data/torch_routes.json`` holds ``last_route`` of the objective, the
content capture and the style capture, and the auto-remat decision, as the
port's forward gave them when ``StyleTransfer`` still decided its routes
itself: VGG-19 (with average and with max pooling), VGG-16 and ResNet-50,
layer sets that stop each gate, extents odd at the image and at each pool
level, widths on both sides of ``dispatch.PAIR_EFF_LIMIT``, the default
switches, ``use_fused=False`` and ``fused_block1=True``, without a mesh and
on CPU meshes of two and four shards. Each case is planned here with no
kernel run and no image made, so the whole table takes seconds.
"""

import collections
import json
import pathlib

import numpy as np
import pytest

from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch import api, networks
from style_transfer_tpu_torch.models import resnet
from style_transfer_tpu_torch.models.weights import random_fixture
from style_transfer_tpu_torch.ops.kernels import dispatch
from style_transfer_tpu_torch.parallel.mesh import make_mesh

TABLE = json.loads((pathlib.Path(__file__).parent / "data" / "torch_routes.json").read_text())
FLAGS = {"chain": {}, "unfused": {"use_fused": False}, "fused_block1": {"fused_block1": True}}
GROUPS = collections.defaultdict(list)
for _case in TABLE["cases"]:
    GROUPS[(_case[0], _case[1])].append(_case)


@pytest.fixture(scope="module")
def models():
    params19, mean, std = random_fixture(0)
    weights = {"vgg19": (params19, None), "vgg19_max": (params19, "max"),
               "vgg16": (random_fixture(0, arch="vgg16")[0], None),
               "resnet50": (resnet.init_params(0), None)}
    made = {}

    def model(arch, shards):
        if (arch, shards) not in made:
            params, pooling = weights[arch]
            mesh = make_mesh(devices=["cpu"] * shards) if shards else None
            made[arch, shards] = StyleTransfer(params, mean=mean, std=std, pooling=pooling,
                                               device="cpu", mesh=mesh)
        return made[arch, shards]

    return model


@pytest.mark.parametrize("arch, layer_set", sorted(GROUPS))
def test_plans_reproduce_the_recorded_routes(models, monkeypatch, arch, layer_set):
    content, style = (tuple(ls) for ls in TABLE["layer_sets"][str(layer_set)])
    routes = [tuple(tuple(p) for p in r) for r in TABLE["routes"]]
    for _, _, h, w, flag, shards, limit, patched, obj, cap_c, cap_s, remat in GROUPS[
            arch, layer_set]:
        st = models(arch, shards)
        cfg = StylizeConfig(content_layers=content, style_layers=style, **FLAGS[flag])
        monkeypatch.setattr(dispatch, "PAIR_EFF_LIMIT", limit)
        with monkeypatch.context() as m:
            if patched:  # remat then says whether the plan reaches the plain path
                m.setattr(api, "REMAT_AUTO_PIXELS", 1)
                for net in (networks.VGG, networks.ResNet50):
                    m.setattr(net, "remat_auto_pixels", 2 ** 62)
            plan = st._plan(cfg, (h, w), content, style)
            assert st._use_remat(cfg, plan, h, w) == bool(remat), (h, w, flag, shards)
        if patched:
            assert plan.full == (not remat)
        if obj is None:
            continue
        case = (h, w, flag, shards, limit)
        assert plan.route == routes[obj], case
        assert st._plan(cfg, (h, w), content, ()).route == routes[cap_c], case
        assert st._plan(cfg, (h, w), (), style).route == routes[cap_s], case


def test_the_table_spans_the_grid():
    """Every network, flag and mesh size, and both sides of the size rule."""
    cases = TABLE["cases"]
    assert {c[0] for c in cases} == {"vgg19", "vgg19_max", "vgg16", "resnet50"}
    assert {c[4] for c in cases} == set(FLAGS) and {c[5] for c in cases} == {0, 2, 4}
    forms = {form for r in TABLE["routes"] for _, form in r}
    assert {"pair", "singles", "conv_gram", "gram_tail", "block1_full", "plain",
            "plain_sharded", "bottlenecks"} <= forms
    assert len(cases) == 2671


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_each_scales_objective_plans_once(models, monkeypatch, optimizer):
    """Through a two-scale ``stylize``: the objective plans each scale once,
    at its first step, and each capture once; the steps reuse the plan."""
    calls = []
    real = networks.VGG.plan

    def plan(self, h, w, content_layers, style_layers, **kw):
        calls.append(((h, w), bool(content_layers) and bool(style_layers)))
        return real(self, h, w, content_layers, style_layers, **kw)

    monkeypatch.setattr(networks.VGG, "plan", plan)
    r = np.random.RandomState(3)
    content, style = r.rand(64, 48, 3).astype(np.float32), r.rand(32, 32, 3).astype(np.float32)
    cfg = StylizeConfig(size=64, min_scale=32, iterations=(3, 3), chunk_size=2,
                        optimizer=api.OptimizerSpec(optimizer))
    models("vgg19", 0).stylize(content, style, cfg)
    objective = [hw for hw, both in calls if both]
    assert objective == [(32, 24), (64, 48)]
    assert len(calls) == 2 * 3  # per scale: the content and style captures, the objective
