"""Image-domain optimizers: Adam and L-BFGS with optax semantics (PyTorch port).

Counterpart of ``style_transfer_tpu/optim.py``. Adam is written out as
``optax.adam`` computes it — ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 +
b2 nu``, bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)`` with eps outside
the square root, scaled by ``-lr``, no clipping of the image — rather than
through ``torch.optim.Adam``, so the two packages take the same steps.

L-BFGS is ``optax.lbfgs(memory_size, linesearch=scale_by_zoom_linesearch(
max_linesearch_steps, tol=linesearch_tol))`` written out, as installed with
the JAX package (optax 0.2.6): ``optax/_src/alias.py:2591`` ``lbfgs`` is
``chain(scale_by_lbfgs, scale(-1), linesearch)``; ``transform.py:1573``
``scale_by_lbfgs`` and ``:1497`` ``_precondition_by_lbfgs`` (the two-loop
recursion over a ring of ``memory_size`` parameter and gradient
differences); the line search is :mod:`style_transfer_tpu_torch.linesearch`.
``torch.optim.LBFGS`` is a different algorithm. Every state is a dataclass
whose leaves (:func:`state_leaves`) are optax's, in optax's order, so a state
the JAX package saved resumes here (``utils/ckpt.py``). States are never
modified in place: an update returns new tensors, so a state kept from an
earlier step stays valid.

``make_chunk_fn`` is a Python loop over steps (the JAX ``lax.scan``); the
host reads the stacked per-step losses once per chunk, and an L-BFGS step
adds one host read per line-search step (``linesearch.py``).

On a mesh (``parallel/mesh.py``) the image is the tuple of its row shards,
each on its own device, as in the JAX package, where the state inherits the
image's sharding: the gradient, Adam's ``mu`` / ``nu`` and every
image-sized L-BFGS and line-search leaf are tuples of shards of the same
rows (the rings ``(m, 1, rows, W, 3)`` per shard), and the scalars (counts,
weights, step sizes) stay on the home device, the first shard's. Adam runs
on the shards with ``torch._foreach_*`` (one launch per op for the shards
of one device); each L-BFGS ``vdot`` is the shards' fp32 partials added on
home in shard order, and the ring index stays on the device. A single
tensor takes the same ops as before.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from style_transfer_tpu_torch.linesearch import (
    ScaleByZoomLinesearch,
    ScaleByZoomLinesearchState,
    axpy,
    safe_increment,
    scale,
    vdot,
)
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.parallel.mesh import map_image, on

ObjectiveFn = Callable[[torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# step :: (image, opt_state) -> (image, opt_state, aux-losses dict)
StepFn = Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Optimizer selection, with the JAX ``OptimizerSpec``'s fields."""

    name: str = "adam"  # "adam" | "lbfgs"
    learning_rate: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    memory_size: int = 10  # L-BFGS history window
    max_linesearch_steps: int = 16
    # Absolute epsilon on the zoom line search's Wolfe conditions. The JAX
    # package measured bf16 VGG gradients at megapixel sizes on its TPU to
    # carry directional-derivative noise below which the strong-Wolfe
    # curvature condition can never be met, so the search spent its whole
    # budget every step; the approximate-Wolfe epsilon absorbs that noise.
    # It relaxes the accept conditions everywhere: an fp32 run may accept a
    # step the exact condition would reject near the margin. The port's
    # measurement on the H100 is in PERF.md. 0.0 = strict Wolfe conditions.
    linesearch_tol: float = 1e-3

    def build(self) -> Union["Adam", "LBFGS"]:
        if self.name == "adam":
            return Adam(self.learning_rate, self.beta1, self.beta2, self.eps)
        if self.name == "lbfgs":
            return LBFGS(self.memory_size, self.max_linesearch_steps, self.linesearch_tol)
        raise ValueError(f"unknown optimizer {self.name!r} (expected 'adam' or 'lbfgs')")

    @property
    def needs_value_fn(self) -> bool:
        """L-BFGS's line search re-evaluates the objective inside the step."""
        return self.name == "lbfgs"


# ------------------------------------------------------------------ states


def state_leaves(state) -> List[Union[torch.Tensor, int]]:
    """The leaves of an optimizer state in optax's flattening order: the
    dataclass fields in order, nested dataclasses walked in place."""
    out: List[Union[torch.Tensor, int]] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(state_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def replace_leaves(state, leaves):
    """A state of ``state``'s structure holding ``leaves`` (in the order of
    :func:`state_leaves`)."""
    it = iter(leaves)

    def build(s):
        return dataclasses.replace(s, **{
            f.name: build(getattr(s, f.name)) if dataclasses.is_dataclass(getattr(s, f.name))
            else next(it)
            for f in dataclasses.fields(s)
        })

    return build(state)


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; the
    learning-rate scale's ``EmptyState`` has no leaves). ``count`` is a host
    integer: the step needs no device value of it."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    """``optax.adam`` on one tensor or on a tuple of row shards, state in
    :class:`AdamState`."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, image) -> AdamState:
        return AdamState(0, map_image(torch.zeros_like, image), map_image(torch.zeros_like, image))

    @torch.no_grad()
    def update(self, grad, state: AdamState, image):
        """Returns (new image, new state); inputs are not modified."""
        if isinstance(grad, tuple):
            return self._update_shards(grad, state, image)
        mu = (1.0 - self.b1) * grad + self.b1 * state.mu
        nu = (1.0 - self.b2) * (grad * grad) + self.b2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1.0 - self.b1 ** count)
        nu_hat = nu / (1.0 - self.b2 ** count)
        step = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return image + step, AdamState(count, mu, nu)

    def _update_shards(self, grad, state: AdamState, image):
        """:meth:`update` on tuples of shards: the same ops in the same order,
        each a ``torch._foreach_*`` over the shards."""
        mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
        mu = add(mul(grad, 1.0 - self.b1), mul(state.mu, self.b1))
        nu = add(mul(mul(grad, grad), 1.0 - self.b2), mul(state.nu, self.b2))
        count = state.count + 1
        mu_hat = div(mu, 1.0 - self.b1 ** count)
        nu_hat = div(nu, 1.0 - self.b2 ** count)
        step = mul(div(mu_hat, add(torch._foreach_sqrt(nu_hat), self.eps)), -self.lr)
        return tuple(add(image, step)), AdamState(count, tuple(mu), tuple(nu))


@dataclasses.dataclass
class ScaleByLBFGSState:
    """optax ``ScaleByLBFGSState``: the iteration (int32), the last
    parameters and gradient, the rings of their differences ``(m, *shape)``
    and the weights ``1 / <du, dw>`` ``(m,)``."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor


@dataclasses.dataclass
class LBFGSState:
    """The state of ``chain(scale_by_lbfgs, scale(-1), linesearch)``: twelve
    leaves, optax's (``scale(-1)`` keeps none)."""

    lbfgs: ScaleByLBFGSState
    linesearch: ScaleByZoomLinesearchState


class LBFGS:
    """``optax.lbfgs`` with the zoom line search, on one tensor.

    ``update(grad, state, image, *, value, value_fn)`` returns ``(updates,
    state)`` as optax does; the next iterate is ``image + updates``.
    ``value_fn(x)`` returns the objective's value and gradient at ``x``; the
    line search calls it once per trial, ``1 + k`` evaluations a step with
    the caller's own.
    """

    def __init__(self, memory_size: int = 10, max_linesearch_steps: int = 16,
                 linesearch_tol: float = 1e-3):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = memory_size
        self.linesearch = ScaleByZoomLinesearch(max_linesearch_steps, tol=linesearch_tol)

    def init(self, image) -> LBFGSState:
        dev, m = M.device_of(image), self.memory_size
        stacked = map_image(lambda x: torch.zeros((m, *x.shape), dtype=x.dtype, device=x.device),
                            image)
        return LBFGSState(
            ScaleByLBFGSState(
                count=torch.zeros((), dtype=torch.int32, device=dev),
                params=map_image(torch.zeros_like, image),
                updates=map_image(torch.zeros_like, image),
                diff_params_memory=stacked,
                diff_updates_memory=stacked,
                weights_memory=torch.zeros(m, dtype=torch.float32, device=dev),
            ),
            self.linesearch.init(image),
        )

    @torch.no_grad()
    def _scale_by_lbfgs(self, updates, state: ScaleByLBFGSState, params):
        """optax ``scale_by_lbfgs`` ``update_fn``: refresh the memory with the
        newest differences, then precondition ``updates``. The ring index
        stays on the device (``index_select`` / ``index_copy``); on a mesh
        each shard's ring takes it on the shard's device."""
        m = self.memory_size
        count = state.count
        memory_idx = torch.remainder(count, m)
        prev_memory_idx = torch.remainder(count - 1, m).reshape(1).long()
        started = count > 0

        # 1. the memory, given fresh params and gradient (zero at count 0)
        diff_params = map_image(torch.sub, params, state.params)
        diff_updates = map_image(torch.sub, updates, state.updates)
        vdot_diff = vdot(diff_updates, diff_params)
        weight = torch.where(vdot_diff == 0.0, 0.0, 1.0 / vdot_diff)
        diff_params = map_image(lambda d: torch.where(on(started, d), d, 0.0), diff_params)
        diff_updates = map_image(lambda d: torch.where(on(started, d), d, 0.0), diff_updates)
        weight = torch.where(started, weight, 0.0)

        def put(memory, d):
            return torch.index_copy(memory, 0, on(prev_memory_idx, memory), d[None])

        diff_params_memory = map_image(put, state.diff_params_memory, diff_params)
        diff_updates_memory = map_image(put, state.diff_updates_memory, diff_updates)
        weights_memory = torch.index_copy(state.weights_memory, 0, prev_memory_idx, weight[None])

        # 2. gamma_k, the scale of the identity; at the first step a capped
        # reciprocal of the gradient norm. The numerator is optax's second
        # vdot of the same (zeroed) differences.
        numerator = torch.where(started, vdot_diff, 0.0)
        denominator = vdot(diff_updates, diff_updates)
        identity_scale = torch.where(denominator > 0.0, numerator / denominator, 1.0)
        update_norm = torch.sqrt(vdot(updates, updates))
        capped_inv_norm = torch.clamp_max(1.0 / update_norm, 1.0)
        identity_scale = torch.where(started, identity_scale, capped_inv_norm)

        # 3. the two-loop recursion, oldest to newest ring slot
        indices = torch.remainder(
            memory_idx + torch.arange(m, dtype=torch.int32, device=count.device), m).long()

        def pick(memory, idx):
            return map_image(lambda mem: mem.index_select(0, on(idx, mem))[0], memory)

        vec, alphas = updates, [None] * m
        for j in reversed(range(m)):
            idx = indices[j:j + 1]
            dwi, dui = pick(diff_params_memory, idx), pick(diff_updates_memory, idx)
            alphas[j] = weights_memory.index_select(0, idx)[0] * vdot(dwi, vec)
            vec = axpy(-alphas[j], dui, vec)
        vec = scale(identity_scale, vec)
        for j in range(m):
            idx = indices[j:j + 1]
            dwi, dui = pick(diff_params_memory, idx), pick(diff_updates_memory, idx)
            beta = weights_memory.index_select(0, idx)[0] * vdot(dui, vec)
            vec = axpy(alphas[j] - beta, dwi, vec)

        return vec, ScaleByLBFGSState(safe_increment(count), params, updates, diff_params_memory,
                                      diff_updates_memory, weights_memory)

    @torch.no_grad()
    def update(self, grad, state: LBFGSState, image, *, value: torch.Tensor, value_fn):
        """Returns ``(updates, new state)``; inputs are not modified."""
        direction, lbfgs_state = self._scale_by_lbfgs(grad, state.lbfgs, image)
        descent = map_image(lambda d: -1.0 * d, direction)
        updates, ls_state = self.linesearch.update(
            descent, state.linesearch, image, value=value, grad=grad,
            value_fn=value_fn,
        )
        return updates, LBFGSState(lbfgs_state, ls_state)


def make_step_fn(objective: ObjectiveFn, spec: OptimizerSpec) -> Tuple[StepFn, Any]:
    """``step(image, state) -> (image, state, aux)``: value and gradient of
    ``objective`` by autograd, then one optimizer update. For L-BFGS the
    update's line search evaluates the objective's value and gradient at
    each trial point; as in the JAX step, the next step evaluates its
    starting point again, although the line search ended there."""
    optimizer = spec.build()

    def value_and_grad(image):
        with torch.enable_grad():
            x = map_image(lambda t: t.detach().requires_grad_(True), image)
            loss, aux = objective(x)
            grad = torch.autograd.grad(loss, x if isinstance(x, tuple) else (x,))
        # autograd hands back the gradient in the layout of the convolutions
        # (channels first under an NHWC view); contiguous, every state tensor
        # has one layout, so a state restored from disk sums as the live one
        grad = tuple(g.contiguous() for g in grad)
        return loss.detach(), (grad if isinstance(x, tuple) else grad[0]), aux

    def value_fn(image):
        loss, grad, _ = value_and_grad(image)
        return loss, grad

    def step(image, state):
        loss, grad, aux = value_and_grad(image)
        if spec.needs_value_fn:
            updates, state = optimizer.update(grad, state, image, value=loss, value_fn=value_fn)
            image = map_image(torch.add, image, updates)
        else:
            image, state = optimizer.update(grad, state, image)
        return image, state, {k: v.detach() for k, v in aux.items()}

    return step, optimizer


def make_chunk_fn(step: StepFn, chunk_size: int):
    """``chunk_size`` steps in a loop; per-step loss terms stacked on the
    device (``{term: (chunk_size,)}``) for one host read per chunk."""

    def run_chunk(image, state):
        rows = []
        for _ in range(chunk_size):
            image, state, aux = step(image, state)
            rows.append(aux)
        losses = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return image, state, losses

    return run_chunk
