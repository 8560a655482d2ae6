"""A mesh of one device is the unsharded chain, bit for bit, in bf16.

The mesh's route-level glue (``scatter_rows``, the content SSE of
``api._mesh_content_loss``, ``all_reduce_to``, the kernels' ``gram_rows`` /
``hw`` windows) is the identity on one shard: the objective's terms and
image gradient must have the unsharded chain's bits. On the CPU in bf16
(the card's dtype; every wrapper runs its plain version) with two shards
the gradient parts from the unsharded one by the bf16 chain's own
sensitivity to a change of summation order, which the mesh phase of
``chip_smoke.py`` measures on the card beside the one-shard case.
"""

import numpy as np
import torch

from style_transfer_tpu_torch import StyleTransfer, StylizeConfig
from style_transfer_tpu_torch.parallel import mesh as M

torch.set_num_threads(2)


def _objective(mesh, h=64):
    r = np.random.RandomState(h)
    content, style = (torch.from_numpy(r.rand(1, h, h, 3).astype(np.float32)) for _ in "cs")
    image = np.clip(content.numpy() + 0.1 * r.randn(1, h, h, 3), 0, 1).astype(np.float32)
    cfg = StylizeConfig(size=(h, h))
    st = StyleTransfer(device="cpu", compute_dtype=torch.bfloat16, mesh=mesh)
    c, s = st._capture_content(cfg, content), st._capture_style(cfg, style)
    x = torch.from_numpy(image).requires_grad_(True)
    loss, terms = st._build_objective(cfg)(x, c, s)
    (g,) = torch.autograd.grad(loss, x)
    return {k: v.detach() for k, v in terms.items()}, g, st.last_route


def test_one_shard_mesh_is_the_unsharded_chain_in_bf16():
    t0, g0, route0 = _objective(None)
    t1, g1, route1 = _objective(M.make_mesh(devices=["cpu"]))
    assert route1 == route0 and ("conv5_1", "conv_gram") in route0
    assert all(torch.equal(t1[k], t0[k]) for k in t0)
    assert torch.equal(g1, g0)
