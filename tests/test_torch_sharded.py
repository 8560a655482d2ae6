"""The port's sharded kernel forms against their unsharded plain versions and
against the JAX package's ``shard_map`` forms.

Each ``make_sharded_*`` of ``style_transfer_tpu_torch/ops/kernels`` (block 1,
the pair for both epilogues, the single for both, ``gram_tail`` and
``conv_gram``) runs on a mesh of CPU shards, where each shard runs the
kernel's plain version on its rows plus its halo. Against the unsharded plain
version (fp32, rtol 1e-5): the output gathered from the shards, the Gram and
the input gradient for a random cotangent on every output, for 1, 2, 3 and 8
shards on ``mesh.row_bounds`` (a last shard taller than the others where the
rows do not divide). Against JAX's sharded form on the forced 8-device CPU
mesh (interpret mode, as ``tests/test_sharding.py`` runs it; rtol 1e-4): the
same on equal shards, the split JAX's forms take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops.pallas import block1_packed as JB1
from style_transfer_tpu.ops.pallas import conv_gram as JCG
from style_transfer_tpu.ops.pallas import conv_pair as JCP
from style_transfer_tpu.ops.pallas import conv_single as JCS
from style_transfer_tpu.parallel import mesh as jmesh
from style_transfer_tpu_torch.ops.kernels import block1 as B1
from style_transfer_tpu_torch.ops.kernels import conv_gram as CG
from style_transfer_tpu_torch.ops.kernels import conv_pair as CP
from style_transfer_tpu_torch.ops.kernels import conv_single as CS
from style_transfer_tpu_torch.parallel import mesh as M

torch.set_num_threads(2)


def _weights(rng, *chain):
    out = []
    for cin, cout in chain:
        out.append((rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        out.append((0.1 * rng.randn(cout)).astype(np.float32))
    return out


# name -> (port unsharded, port sharded maker, JAX sharded maker, convs, cin,
#          has activation output, pool)
def _forms(pool, gram):
    return {
        "pair": (lambda x, *w: CP.conv_pair(x, *w, pool=pool, gram=gram),
                 lambda m: CP.make_sharded_pair(m, pool=pool, gram=gram),
                 lambda jm: JCP.make_sharded_pair(jm, jmesh.SPATIAL_AXIS, pool=pool, gram=gram),
                 ((8, 16), (16, 16)), 8, True),
        "single": (CS.make_conv_single(pool=pool, gram=gram),
                   lambda m: CS.make_sharded_single(m, pool=pool, gram=gram),
                   lambda jm: JCS.make_sharded_single(jm, jmesh.SPATIAL_AXIS, pool=pool,
                                                      gram=gram),
                   ((16, 16),), 16, True),
    }


FIXED = {
    "block1": (B1.block1_packed, B1.make_sharded_block1,
               lambda jm: JB1.make_sharded_block1(jm, jmesh.SPATIAL_AXIS),
               ((3, 64), (64, 64)), 3, True, True, True),
    "gram_tail": (CS.gram_tail, CS.make_sharded_gram_tail,
                  lambda jm: JCS.make_sharded_gram_tail(jm, jmesh.SPATIAL_AXIS),
                  ((16, 16),), 16, False, False, True),
    "conv_gram": (CG.conv_gram, CG.make_sharded_conv_gram,
                  lambda jm: JCG.make_sharded_conv_gram(jm, jmesh.SPATIAL_AXIS),
                  ((16, 16),), 16, False, False, True),
}


def _case(name):
    """(unsharded, sharded maker, JAX maker, convs, cin, out, pool, gram)."""
    if name in FIXED:
        return FIXED[name]
    form, pool, gram = name.split("-")
    pool, gram = pool == "pool", gram == "gram"
    return (*_forms(pool, gram)[form], pool, gram)


NAMES = [f"{f}-{p}-{g}" for f in ("pair", "single") for p in ("pool", "nopool")
         for g in ("gram", "nogram")] + list(FIXED)
# against JAX: each of the five wrappers with every epilogue it has at 1, 2,
# 3 and 8 shards, and the chain's other epilogue pairs at 3 and 8 (a JAX
# reference costs a jit of its interpret-mode kernels, about 1.5 s)
JAX_CASES = ([(name, n) for name in ("pair-pool-gram", "single-pool-gram", *FIXED)
              for n in (1, 2, 3, 8)]
             + [(name, n) for name in ("pair-nopool-gram", "pair-pool-nogram",
                                       "single-nopool-gram", "single-pool-nogram")
                for n in (3, 8)])


def _split(out, has_out, gram):
    if has_out and gram:
        return out
    return (None, out) if gram else (out, None)


def _run_torch(fn, x, w, cts, *, sharded=None, bounds=None, has_out, gram):
    """Forward, then the input gradient of <out, ct_out> + <gram, ct_gram>;
    ``sharded`` a mesh: ``fn`` takes and gives shards on ``bounds``."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a) for a in w]
    inp = xt if sharded is None else M.scatter_rows(xt, bounds, sharded)
    out, g = _split(fn(inp, *wt), has_out, gram)
    if sharded is not None and out is not None:
        out = M.gather_rows(out, "cpu")
    loss = sum((t * torch.from_numpy(c)).sum() for t, c in zip((out, g), cts) if t is not None)
    (dx,) = torch.autograd.grad(loss, xt)
    return [t.detach().numpy() for t in (out, g) if t is not None] + [dx.numpy()]


def _data(name, h, seed=0):
    """Input, weights and the cotangents of the activation and the Gram."""
    _, _, _, convs, cin, has_out, pool, gram = _case(name)
    rng = np.random.RandomState(seed)
    w = _weights(rng, *convs)
    x = rng.rand(1, h, 12, cin).astype(np.float32)
    out_shape = (1, h // 2 if pool else h, 6 if pool else 12, convs[-1][1])
    cts = [rng.randn(*out_shape).astype(np.float32) if has_out else None,
           rng.randn(convs[0][1], convs[0][1]).astype(np.float32) if gram else None]
    return x, w, cts


def _close(got, want, rtol):
    for g, r in zip(got, want):
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_unsharded_plain(name, n):
    """Rows 16 n + 6 on ``row_bounds``: a last shard 6 rows taller than the
    others (one shard of 22 rows for n = 1)."""
    unsharded, make, _, _, _, has_out, pool, gram = _case(name)
    h = 16 * n + 6
    x, w, cts = _data(name, h)
    mesh = M.make_mesh(devices=["cpu"] * n)
    bounds = M.row_bounds(h, n)
    assert len(bounds) == n and bounds[-1][1] - bounds[-1][0] == 22
    want = _run_torch(unsharded, x, w, cts, has_out=has_out, gram=gram)
    got = _run_torch(make(mesh), x, w, cts, sharded=mesh, bounds=bounds, has_out=has_out,
                     gram=gram)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name, n", JAX_CASES)
def test_sharded_matches_jax_sharded(name, n):
    """Equal shards of 4 rows (8 for the pair and block 1, whose JAX forms
    need 4 rows of halo and even shards) on JAX's n-device sub-mesh."""
    _, make, jmake, _, _, has_out, pool, gram = _case(name)
    h_l = 8 if name.startswith(("pair", "block1")) else 4
    h = h_l * n
    x, w, cts = _data(name, h, seed=1)
    jm = jmesh.make_mesh(n)
    jfn = jmake(jm)
    jw = [jnp.asarray(a) for a in w]

    def loss(xx):
        out, g = _split(jfn(xx, *jw), has_out, gram)
        return sum(jnp.sum(t * c) for t, c in zip((out, g), cts) if t is not None), (out, g)

    xs = jmesh.shard_image(jnp.asarray(x), jm)
    (_, (jout, jg)), jdx = jax.jit(jax.value_and_grad(loss, has_aux=True))(xs)
    want = [np.asarray(t) for t in (jout, jg) if t is not None] + [np.asarray(jdx)]
    mesh = M.make_mesh(devices=["cpu"] * n)
    bounds = tuple((i * h_l, (i + 1) * h_l) for i in range(n))
    got = _run_torch(make(mesh), x, w, cts, sharded=mesh, bounds=bounds, has_out=has_out,
                     gram=gram)
    _close(got, want, 1e-4)


def test_gram_counts_each_row_once():
    """The sharded Gram sums each shard's own rows only: a Gram taken over
    each shard's halo rows as well (no ``gram_rows``) counts 2 halo rows
    twice at every interior boundary, which this shape shows at 1e-2, a
    thousand times the tolerance the sharded form meets."""
    h, n = 16 * 8, 8
    x, w, _ = _data("pair-nopool-gram", h)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(a) for a in w]
    mesh = M.make_mesh(devices=["cpu"] * n)
    xs = M.scatter_rows(xt, M.row_bounds(h, n), mesh)
    want = CP.conv_pair(xt, *wt, pool=False, gram=True)[1]
    got = CP.make_sharded_pair(mesh, pool=False, gram=True)(xs, *wt)[1]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    def whole_extension(x, dev, rows, hw):  # the fault: no row window
        return CP.conv_pair(x, *wt, pool=False, gram=True, hw=hw)

    wrong = M.map_shards(whole_extension, xs, CP.HALO, pool=False, gram=True, home="cpu")[1]
    assert float((wrong - want).norm() / want.norm()) > 1e-2


def test_edge_shards_take_no_halo_rows():
    """An edge shard's kernel pads with zeros: giving it zero-filled halo
    rows instead would not be SAME padding after the first conv (they
    become relu(bias)). The sharded pair's output at the image's first and
    last rows equals the unsharded one exactly."""
    h, n = 48, 3
    x, w, _ = _data("pair-nopool-nogram", h)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(a) for a in w]
    mesh = M.make_mesh(devices=["cpu"] * n)
    outs = CP.make_sharded_pair(mesh, pool=False, gram=False)(
        M.scatter_rows(xt, M.row_bounds(h, n), mesh), *wt)
    want = CP.conv_pair(xt, *wt, pool=False, gram=False)
    torch.testing.assert_close(outs[0][:, :2], want[:, :2], rtol=0, atol=0)
    torch.testing.assert_close(outs[-1][:, -2:], want[:, -2:], rtol=0, atol=0)
    padded = torch.nn.functional.pad(xt[:, :18], (0, 0, 0, 0, 2, 0))  # zero "halo" rows
    zero_fill = CP.conv_pair(padded, *wt, pool=False, gram=False)[:, 2:4]
    assert float((zero_fill - want[:, :2]).abs().max()) > 1e-3


def test_pooled_shards_must_pair_rows():
    """A pool cannot pair rows across a shard that starts on an odd row."""
    x, w, _ = _data("pair-pool-nogram", 20)
    mesh = M.make_mesh(devices=["cpu"] * 2)
    xs = M.scatter_rows(torch.from_numpy(x), ((0, 9), (9, 20)), mesh)
    with pytest.raises(ValueError, match="even rows"):
        CP.make_sharded_pair(mesh, pool=True, gram=False)(xs, *map(torch.from_numpy, w))
