"""Accuracy limits of the CUDA kernels against their plain PyTorch versions.

One definition for every check on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``). The error is the relative Frobenius error
``||k - r|| / ||r||`` of the kernel's output against the plain version run
in fp32 on the same bf16-valued inputs, weights and cotangents (TF32 off).

bf16 keeps 8 bits of mantissa (relative step 3.9e-3); the kernels
accumulate in fp32 and round once per stored tensor. Measured on an H100
80GB HBM3 (700 W) at the 512 px main-path shapes with random biases:
forward activations at most 2.4e-3 (the plain version in bf16: 3.3e-3),
Grams at most 5e-5 (plain bf16: 1.3e-3), input gradients at most 3.3e-2
(plain bf16: 4.3e-2 — a gradient through two transposed convs cancels
large terms of both signs, which magnifies the bf16 rounding of the stored
cotangents). The absolute limits are about twice the worst kernel error or
more, and above what the plain bf16 path itself reaches on activations and
gradients. The TV kernel is fp32 and matches to summation order.

The single-conv kernels (``conv_single.py``) need no limits of their own.
At the large-image shapes (128x2048 64->128, 32x512 256->512, conv5_1's
``gram_tail`` at 32x512) they measured activations 1.7e-3 (plain bf16:
2.3e-3), Grams at most 3e-5 (plain bf16: 1.2e-3) and input gradients at
most 3.3e-3 (plain bf16: 1.4-1.6e-2): one transposed conv cancels less than
the pair's two.

The one-pass block-1 kernels (``block1.py``: ``block1_full``,
``block1_tail``) use the same limits as the pair they replace. The fused
losses (``epilogue.py``) sum in fp32 from the unrounded difference, so the
scalar matches the fp32 plain version to summation order (:data:`TOL_LOSS`);
their gradient is the stored difference, rounded once to the activation's
dtype (:data:`TOL_ACT`; exact for fp32 inputs and for the fp32 Grams).

Each output must also be no less accurate than the plain version run in
bf16, up to :data:`PLAIN_RATIO` and :data:`PLAIN_SLACK` (the slack covers
the statistics of small tensors), so a kernel that drifts while staying
under its absolute limit still fails.
"""

TOL_ACT = 1e-2  # bf16 activations (pool1, pair outputs, conv4_2)
TOL_GRAM = 1e-3  # fp32 Grams
TOL_DX = 6e-2  # bf16 input gradients
TOL_TV = 1e-5  # the fp32 TV loss and its gradient
TOL_LOSS = 1e-5  # the fp32 content and style losses (scalars)
# L-BFGS through stylize() (chip_smoke.py, phase lbfgs): configuration 4 on
# the kernel chain against the same run on the plain fp32 path, measured on
# an H100 80GB HBM3 (700 W) over 256 -> 512 -> 1024 px, 20 steps a scale in
# chunks of 10, four runs in three calls. The kernel path's curve had the
# same bits in every run; the fp32 witness's did not (cuDNN's algorithms
# vary from run to run, and L-BFGS carries a difference on): two witness
# runs in one call differed by up to 4.8e-2 at a chunk's end. The kernel
# path's loss at a chunk's end was within 5.1e-2 of the witness's: limit
# TOL_LBFGS_CHUNK, twice either spread. Within the first chunk
# the curves part by 0.120 at the third step in every run (0.0884 against
# 0.1005): the first step changes the loss by 1e-4 relative, so the gradient
# difference it stores is mostly bf16 rounding, the second step's scale
# <du, dw> / <du, du> differs between the paths, and from there the two go
# down different paths: limit TOL_LBFGS_CURVE on the first chunk's steps.
TOL_LBFGS_CHUNK = 0.1
TOL_LBFGS_CURVE = 0.25

# The mesh (parallel/mesh.py) against the unsharded chain, both on the card
# in bf16 (chip_smoke.py, phase mesh; parallel/dryrun.py): the same kernels
# on the same rows, but each shard's Gram partials sum in another order, the
# Grams are sums of per-shard partials, a halo row's input cotangent is the
# fp32 sum of two bf16 partials rounded once where the unsharded kernel
# rounds one fp32 sum, and the plain sharded layers run cuDNN on shard
# shapes. Measured on an H100 80GB HBM3 (700 W), three runs with the same
# bits: loss terms at most 5.8e-5 relative (2048^2, 8 shards), the image
# gradient 2.7e-3-2.8e-3 relative Frobenius at 2048^2, 512^2, 128^2 and
# 1080x1920 with 2 to 8 shards, and 6.2e-3 in the dryrun's 128x2048 natural
# variant, cosine at least 0.99998 — while both sides lie 2.6e-2 to 3.2e-2
# from the plain fp32 path, equally. Limits: the terms, relative (17x the
# worst); the gradient, relative Frobenius (1.6x the worst) and cosine.
# Configuration 5 through stylize() (8 shards, 20 steps a scale) is held to
# chip_smoke.py's TOL_CURVE (3e-2) against the unsharded run: measured
# 2.51e-2 at the 3840 px scale, the same in three runs; the plain fp32
# path's distance to the unsharded run there was 7.1e-3 in one call and
# 2.5e-2 in the next (cuDNN's fp32 algorithms vary between calls).
TOL_MESH_TERMS = 1e-3
TOL_MESH_GRAD = 1e-2
TOL_MESH_COS = 0.9999

PLAIN_RATIO = 1.5
PLAIN_SLACK = 1e-3


def within(rel: float, plain_rel: float, tol: float) -> bool:
    """Whether a kernel's error ``rel`` passes: at most ``tol``, and at most
    ``PLAIN_RATIO * plain_rel + PLAIN_SLACK`` for the plain bf16 version's
    error ``plain_rel`` against the same fp32 reference."""
    return rel <= tol and rel <= PLAIN_RATIO * plain_rel + PLAIN_SLACK
