"""Zoom line search with optax semantics (PyTorch port).

Counterpart of ``optax.scale_by_zoom_linesearch`` and the ``zoom_linesearch``
it runs, as installed with the JAX package (optax 0.2.6,
``optax/_src/linesearch.py``: ``_cubicmin`` ``:455``, ``_quadmin`` ``:496``,
``zoom_linesearch`` ``:576``, ``scale_by_zoom_linesearch`` ``:1331``). Every
branch is carried over: the interval search from the previous step size
(``initial_guess_strategy="keep"``) growing by ``increase_factor``; the zoom
by cubic, then quadratic, then bisection, with the ``0.2 delta`` and ``0.1
delta`` checks and the interval threshold; the decrease error with the
approximate-Wolfe term and ``tol``; the curvature error; the safe-step
bookkeeping and ``_try_safe_step``; the failure when the direction does not
descend; and the ``max_linesearch_steps`` cutoff. The constants are
optax's defaults, which the JAX package keeps (``increase_factor`` 2,
``slope_rtol`` 1e-4, ``curv_rtol`` 0.9, ``approx_dec_rtol`` 1e-6,
``stepsize_precision`` 1e-5); the options no caller sets (a largest step
size, the initial guess "one", ``verbose`` diagnostics) are left out.

Every scalar of the search is a 0-d fp32 tensor on the image's device (the
counts int32, the flags bool) and every ``jnp.where`` is a ``torch.where`` on
the same operands, so the decisions near a margin are optax's, including the
IEEE inf and NaN of ``_cubicmin`` / ``_quadmin`` that the interval checks
then reject. ``jax.lax.cond`` on ``interval_found`` becomes what it compiles
to: both branches' scalar arithmetic runs, the trial point is selected on the
device, the objective is evaluated there once, and each field of the new
state is selected. JAX runs the loop as a ``lax.while_loop`` on the device;
here the host decides whether to go on, which costs **one host read per
line-search step** (``done | failed`` after each step; the first test is
skipped, the initial state never stops) and nothing else: a step of L-BFGS
whose search takes k steps reads the device k times (:data:`host_reads`
counts them). Each trial's autograd graph is freed by ``value_fn`` before
the next trial, so the search holds one forward and backward at a time.

On a mesh the image-sized leaves (``params``, ``updates``, ``grad``,
``safe_grad``) are tuples of row shards, each on its own device
(``parallel/mesh.py``); every scalar stays on the home device, the first
shard's, and is copied to a shard's device where that shard's arithmetic
needs it (``on``; no copy on a mesh that repeats one device), and
:func:`vdot` adds the shards' fp32 partial dots on home in shard order.
The host read per step is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from style_transfer_tpu_torch.ops.kernels._build import LaunchCount
from style_transfer_tpu_torch.parallel import mesh as M
from style_transfer_tpu_torch.parallel.mesh import map_image, on

ValueAndGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

INT32_MAX = 2**31 - 1
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5  # optax's stepsize_precision

# the line search's host reads, counted like the kernels' launches (reset by
# setting ``n = 0``)
host_reads = LaunchCount("linesearch.host_reads")


def vdot(a, b) -> torch.Tensor:
    """``optax.tree.real(optax.tree.vdot(a, b))`` for one real fp32 leaf;
    for two tuples of row shards, each shard's fp32 dot on its device,
    added on the first shard's (the mesh's home) in shard order."""
    if isinstance(a, tuple):
        return M.all_reduce_to([torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)],
                               a[0].device)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` with a scalar ``cond``, shard by shard on
    tuples of shards."""
    return map_image(lambda x, y: torch.where(on(cond, x), x, y), a, b)


def axpy(alpha: torch.Tensor, x, y):
    """``y + alpha * x`` for a scalar ``alpha``, shard by shard on tuples."""
    return map_image(lambda u, v: v + on(alpha, u) * u, x, y)


def scale(alpha: torch.Tensor, x):
    """``alpha * x`` for a scalar ``alpha``, shard by shard on tuples."""
    return map_image(lambda u: on(alpha, u) * u, x)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``optax.safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < INT32_MAX, count + 1, count)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope ``fpa`` at a; NaN when the radical is negative (optax
    ``_cubicmin``, from scipy)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    B = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    ``fpa`` at a (optax ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


@dataclasses.dataclass
class ZoomState:
    """optax ``ZoomLinesearchState``, its fields in optax's order."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    stepsize_guess: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _select(cond: torch.Tensor, a: ZoomState, b: ZoomState) -> ZoomState:
    """Field by field ``torch.where(cond, a, b)`` (``lax.cond``'s select);
    a field both states share is passed through."""
    out = {}
    for f in dataclasses.fields(ZoomState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = x if x is y else where(cond, x, y)
    return ZoomState(**out)


class ZoomLinesearch:
    """optax ``zoom_linesearch``: ``init``, ``step``, ``cond`` and the loop
    :meth:`run`."""

    def __init__(self, max_linesearch_steps: int, tol: float = 0.0):
        self.max_linesearch_steps = max_linesearch_steps
        self.tol = tol

    # --------------------------------------------------------------- errors

    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        """Armijo error, or the approximate (Hager-Zhang) one near the
        minimizer, clipped at 0; NaN becomes inf."""
        decrease_error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        approx = torch.maximum(approx, delta_values)
        decrease_error = torch.minimum(approx, decrease_error)
        decrease_error = torch.clamp_min(decrease_error, 0.0)
        return torch.where(torch.isnan(decrease_error), torch.inf, decrease_error)

    def _curvature_error(self, slope_step, slope_init):
        curvature_error = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
        curvature_error = torch.clamp_min(curvature_error, 0.0)
        return torch.where(torch.isnan(curvature_error), torch.inf, curvature_error)

    # ----------------------------------------------------------- the state

    def init(self, updates: torch.Tensor, params: torch.Tensor, *, value: torch.Tensor,
             grad: torch.Tensor, prev_stepsize: torch.Tensor) -> ZoomState:
        """optax ``init_fn`` under ``initial_guess_strategy="keep"``: the first
        trial is ``prev_stepsize``."""
        dev = M.device_of(params)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        value = value.to(torch.float32)
        slope = vdot(updates, grad)
        return ZoomState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, updates=updates, stepsize_guess=prev_stepsize,
            stepsize=zero, value=value, grad=grad, slope=slope,
            value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf, error=inf,
            interval_found=false, done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad,
        )

    # ------------------------------------------------------ the two phases

    @staticmethod
    def _search_point(s: ZoomState):
        """Trial of the interval search (Nocedal-Wright Algorithm 3.5): the
        guess first, then ``INCREASE_FACTOR`` times the last step size."""
        return torch.where(s.count == 0, s.stepsize_guess, INCREASE_FACTOR * s.stepsize)

    def _search_interval(self, s: ZoomState, new_stepsize, new_value, new_grad,
                         new_slope) -> ZoomState:
        iter_num = s.count
        prev_stepsize, prev_value, prev_slope = s.stepsize, s.value, s.slope
        decrease_error = self._decrease_error(new_stepsize, new_value, new_slope,
                                              s.value_init, s.slope_init)
        curvature_error = self._curvature_error(new_slope, s.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)

        # a point with sufficient decrease is kept in case the curvature
        # condition cannot be met
        safe_decrease = decrease_error <= self.tol
        safe_stepsize = torch.where(safe_decrease, new_stepsize, s.safe_stepsize)
        safe_value = torch.where(safe_decrease, new_value, s.safe_value)
        safe_grad = where(safe_decrease, new_grad, s.safe_grad)

        set_high_to_new = (decrease_error > 0.0) | ((new_value >= prev_value) & (iter_num > 0))
        set_low_to_new = (new_slope >= 0.0) & (~set_high_to_new)
        low = torch.where(set_low_to_new, new_stepsize, prev_stepsize)
        value_low = torch.where(set_low_to_new, new_value, prev_value)
        slope_low = torch.where(set_low_to_new, new_slope, prev_slope)
        high = torch.where(set_low_to_new, prev_stepsize, new_stepsize)
        value_high = torch.where(set_low_to_new, prev_value, new_value)
        slope_high = torch.where(set_low_to_new, prev_slope, new_slope)

        interval_found = set_high_to_new | set_low_to_new | (new_error <= self.tol)
        done = new_error <= self.tol
        failed = (iter_num + 1 >= self.max_linesearch_steps) & (~done)
        return ZoomState(
            count=safe_increment(iter_num),
            params=s.params, updates=s.updates, stepsize_guess=s.stepsize_guess,
            stepsize=new_stepsize, value=new_value, grad=new_grad, slope=new_slope,
            value_init=s.value_init, slope_init=s.slope_init,
            decrease_error=decrease_error, curvature_error=curvature_error, error=new_error,
            interval_found=interval_found, done=done, failed=failed,
            low=low, value_low=value_low, slope_low=slope_low,
            high=high, value_high=value_high, slope_high=slope_high,
            cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=safe_stepsize, safe_value=safe_value, safe_grad=safe_grad,
        )

    def _zoom_point(self, s: ZoomState):
        """Trial of the zoom (Nocedal-Wright Algorithm 3.6): the cubic
        minimizer if it lies well inside the interval, else the quadratic's,
        else the midpoint. Returns it and whether the interval is too small."""
        low, high = s.low, s.high
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= INTERVAL_THRESHOLD

        middle_cubic = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                                 s.cubic_ref, s.value_cubic_ref)
        use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        middle_quad_valid = (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
        use_quad = (~use_cubic) & middle_quad_valid
        middle_bisection = (low + high) / 2.0
        use_bisection = (~use_cubic) & (~use_quad)

        middle = torch.where(use_cubic, middle_cubic, s.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, middle_bisection, middle)
        return middle, too_small_int

    def _zoom_into_interval(self, s: ZoomState, middle, too_small_int,
                            value_middle, grad_middle, slope_middle) -> ZoomState:
        iter_num = s.count
        low, value_low, slope_low = s.low, s.value_low, s.slope_low
        high, value_high, slope_high = s.high, s.value_high, s.slope_high
        decrease_error = self._decrease_error(middle, value_middle, slope_middle,
                                              s.value_init, s.slope_init)
        curvature_error = self._curvature_error(slope_middle, s.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)

        # keep the point with sufficient decrease and the smallest value
        safe_decrease = decrease_error <= self.tol
        update_safe = safe_decrease & (value_middle < s.safe_value)
        safe_stepsize = torch.where(update_safe, middle, s.safe_stepsize)
        safe_value = torch.where(update_safe, value_middle, s.safe_value)
        safe_grad = where(update_safe, grad_middle, s.safe_grad)

        done = new_error <= self.tol

        set_high_to_middle = (decrease_error > 0.0) | (value_middle >= value_low)
        secant_interval = slope_middle * (high - low)
        set_high_to_low = (secant_interval >= 0.0) & (~set_high_to_middle)
        set_low_to_middle = ~set_high_to_middle

        new_high = torch.where(set_high_to_middle, middle, high)
        new_value_high = torch.where(set_high_to_middle, value_middle, value_high)
        new_slope_high = torch.where(set_high_to_middle, slope_middle, slope_high)
        new_high = torch.where(set_high_to_low, low, new_high)
        new_value_high = torch.where(set_high_to_low, value_low, new_value_high)
        new_slope_high = torch.where(set_high_to_low, slope_low, new_slope_high)

        new_low = torch.where(set_low_to_middle, middle, low)
        new_value_low = torch.where(set_low_to_middle, value_middle, value_low)
        new_slope_low = torch.where(set_low_to_middle, slope_middle, slope_low)

        # the old high is the next cubic reference if high moved, else the
        # old low (which low replaced and high did not take)
        high_moved = set_high_to_middle | set_high_to_low
        new_cubic_ref = torch.where(high_moved, high, low)
        new_value_cubic_ref = torch.where(high_moved, value_high, value_low)

        # stop on an interval below the threshold only once a step with
        # sufficient decrease is known (steep functions need tiny steps)
        max_iter_reached = (iter_num + 1) >= self.max_linesearch_steps
        presumably_failed = max_iter_reached | (too_small_int & (safe_stepsize > 0.0))
        failed = presumably_failed & ~done
        return ZoomState(
            count=safe_increment(iter_num),
            params=s.params, updates=s.updates, stepsize_guess=s.stepsize_guess,
            stepsize=middle, value=value_middle, grad=grad_middle, slope=slope_middle,
            value_init=s.value_init, slope_init=s.slope_init,
            decrease_error=decrease_error, curvature_error=curvature_error, error=new_error,
            interval_found=s.interval_found, done=done, failed=failed,
            low=new_low, value_low=new_value_low, slope_low=new_slope_low,
            high=new_high, value_high=new_value_high, slope_high=new_slope_high,
            cubic_ref=new_cubic_ref, value_cubic_ref=new_value_cubic_ref,
            safe_stepsize=safe_stepsize, safe_value=safe_value, safe_grad=safe_grad,
        )

    @staticmethod
    def _try_safe_step(s: ZoomState) -> ZoomState:
        """On failure, fall back to the safe step (sufficient decrease, the
        curvature condition unmet), or to no step at all when every trial
        left the domain; the errors stay those of the last trial."""
        outside_domain = torch.isinf(s.decrease_error)
        use_safe = (s.safe_stepsize > 0.0) | outside_domain
        return dataclasses.replace(
            s,
            stepsize=torch.where(use_safe, s.safe_stepsize, s.stepsize),
            value=torch.where(use_safe, s.safe_value, s.value),
            grad=where(use_safe, s.safe_grad, s.grad),
        )

    # ------------------------------------------------------------ the loop

    def step(self, s: ZoomState, value_and_grad_fn: ValueAndGradFn) -> ZoomState:
        """optax ``step_fn``: one trial, by the search or the zoom as
        ``interval_found`` says, then the safe step if it failed."""
        search_stepsize = self._search_point(s)
        zoom_stepsize, too_small_int = self._zoom_point(s)
        stepsize = torch.where(s.interval_found, zoom_stepsize, search_stepsize)
        value, grad = value_and_grad_fn(axpy(stepsize, s.updates, s.params))
        value = value.to(torch.float32)
        slope = vdot(grad, s.updates)
        zoomed = self._zoom_into_interval(s, stepsize, too_small_int, value, grad, slope)
        searched = self._search_interval(s, stepsize, value, grad, slope)
        new = _select(s.interval_found, zoomed, searched)
        return _select(new.failed, self._try_safe_step(new), new)

    @staticmethod
    def cond(s: ZoomState) -> torch.Tensor:
        """Whether the search goes on (a device bool)."""
        return ~(s.done | s.failed)

    def run(self, s: ZoomState, value_and_grad_fn: ValueAndGradFn) -> ZoomState:
        """The ``lax.while_loop``: steps until done or failed, one host read
        of :meth:`cond` after each step."""
        while True:
            s = self.step(s, value_and_grad_fn)
            host_reads.add("cond", ())
            if not bool(self.cond(s)):
                return s


@dataclasses.dataclass
class ScaleByZoomLinesearchState:
    """optax ``ScaleByZoomLinesearchState`` with its ``info``
    (``ZoomLinesearchInfo``) in place, leaves in optax's order."""

    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    num_linesearch_steps: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


class ScaleByZoomLinesearch:
    """optax ``scale_by_zoom_linesearch``: scales ``updates`` by a step size
    that satisfies the decrease and curvature conditions, within ``tol``; the
    first trial is the last step's."""

    def __init__(self, max_linesearch_steps: int, tol: float = 0.0):
        self.search = ZoomLinesearch(max_linesearch_steps, tol=tol)

    def init(self, params: torch.Tensor) -> ScaleByZoomLinesearchState:
        dev = M.device_of(params)
        return ScaleByZoomLinesearchState(
            learning_rate=torch.ones((), dtype=torch.float32, device=dev),
            value=torch.full((), torch.inf, dtype=torch.float32, device=dev),
            grad=map_image(torch.zeros_like, params),
            num_linesearch_steps=torch.zeros((), dtype=torch.int32, device=dev),
            decrease_error=torch.full((), torch.inf, dtype=torch.float32, device=dev),
            curvature_error=torch.full((), torch.inf, dtype=torch.float32, device=dev),
        )

    @torch.no_grad()
    def update(self, updates: torch.Tensor, state: ScaleByZoomLinesearchState,
               params: torch.Tensor, *, value: torch.Tensor, grad: torch.Tensor,
               value_fn: ValueAndGradFn):
        """Returns ``(learning_rate * updates, new state)``. ``value_fn(x)``
        returns the objective's value and gradient at ``x``."""
        s = self.search.init(updates, params, value=value, grad=grad,
                             prev_stepsize=state.learning_rate)
        s = self.search.run(s, value_fn)
        new_state = ScaleByZoomLinesearchState(
            learning_rate=s.stepsize, value=s.value, grad=s.grad,
            num_linesearch_steps=s.count, decrease_error=s.decrease_error,
            curvature_error=s.curvature_error,
        )
        return scale(s.stepsize, updates), new_state
