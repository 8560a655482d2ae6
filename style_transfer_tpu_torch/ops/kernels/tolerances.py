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

Each output must also be no less accurate than the plain version run in
bf16, up to :data:`PLAIN_RATIO` and :data:`PLAIN_SLACK` (the slack covers
the statistics of small tensors), so a kernel that drifts while staying
under its absolute limit still fails.
"""

TOL_ACT = 1e-2  # bf16 activations (pool1, pair outputs, conv4_2)
TOL_GRAM = 1e-3  # fp32 Grams
TOL_DX = 6e-2  # bf16 input gradients
TOL_TV = 1e-5  # the fp32 TV loss and its gradient

PLAIN_RATIO = 1.5
PLAIN_SLACK = 1e-3


def within(rel: float, plain_rel: float, tol: float) -> bool:
    """Whether a kernel's error ``rel`` passes: at most ``tol``, and at most
    ``PLAIN_RATIO * plain_rel + PLAIN_SLACK`` for the plain bf16 version's
    error ``plain_rel`` against the same fp32 reference."""
    return rel <= tol and rel <= PLAIN_RATIO * plain_rel + PLAIN_SLACK
