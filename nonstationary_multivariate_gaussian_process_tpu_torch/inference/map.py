"""MAP inference engine: guarded best-seen Adam and L-BFGS on a negative log
posterior.

Counterpart of the JAX package's ``inference/map.py`` (reference training
loops, e.g. ``Nonseparable_Model/Nonseparable_model.py:158-210``).  The port
runs eagerly; the optimizers carry their own arithmetic so that a run
follows the JAX one iterate by iterate:

* **Adam** is optax's ``chain(scale_by_adam(), scale(-1), per-slot lr)``
  written out: β1 = 0.9, β2 = 0.999, ε = 1e-8, moments
  ``(1 − β)·g^k + β·m`` and bias correction ``m / (1 − β^count)``.  Its
  steps stay on the device (no host synchronization per step).
* **L-BFGS** is optax 0.2.6's ``lbfgs(memory_size=10)``:
  ``scale_by_lbfgs(scale_init_precond=True)`` (with the capped first-step
  scaling ``min(1, 1/‖g‖)``), ``scale(-1)``, then
  ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` — Nocedal & Wright's interval search and
  zoom with the cubic/quadratic interpolation and its safeguards, the
  Hager–Zhang approximate decrease test and the safe-step fallback — and
  the reuse of the accepted value and gradient
  (``optax.value_and_grad_from_state``).  The linesearch's decisions are
  host control flow: each probe brings its value and slope to the host.

The guard semantics are part of the result: a non-finite value or gradient
holds the parameters (and Adam's moments), the optimum is the best point
visited, and the final iterate gets one more chance.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

#: optax.scale_by_zoom_linesearch defaults, as optax.lbfgs sets them.
LS_MAX_STEPS = 20
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INCREASE = 2.0
LS_INTERVAL_THRESHOLD = 1e-5
LS_TOL = 0.0

METHODS = ("adam", "lbfgs")


class MapResult(NamedTuple):
    vec: torch.Tensor  # best-seen parameter vector (lowest objective visited)
    target_hist: torch.Tensor  # per-iteration log-posterior values (−objective)
    n_iters: int  # iterations actually run
    converged: bool


def value_and_grad(objective: Callable, v: torch.Tensor):
    """``(objective(v), ∇objective(v))`` with both detached."""
    with torch.enable_grad():
        v_ = v.detach().requires_grad_(True)
        val = objective(v_)
        (grad,) = torch.autograd.grad(val, v_)
    return val.detach(), grad


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(v: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(v), torch.zeros_like(v))


def guarded_adam_step(objective, lr_vec: torch.Tensor, v, state: AdamState, best_vec, best_val):
    """One guarded best-seen Adam step; returns ``(v, state, best_vec,
    best_val, −value)`` with every value a device tensor.

    A non-finite value or gradient skips the update (parameters and moments
    hold, the step count advances); the best-seen iterate is tracked because
    Adam at these learning rates descends fast and then destabilizes.
    """
    val, grad = value_and_grad(objective, v)
    ok = torch.isfinite(val) & torch.isfinite(grad).all()
    better = ok & (val < best_val)
    best_vec = torch.where(better, v, best_vec)
    best_val = torch.where(better, val, best_val)
    grad = torch.where(ok, grad, torch.zeros_like(grad))
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * state.nu
    count = state.count + 1
    mu_hat = mu / (1 - ADAM_B1**count)
    nu_hat = nu / (1 - ADAM_B2**count)
    updates = mu_hat / (torch.sqrt(nu_hat + 0.0) + ADAM_EPS)
    updates = updates * -1.0
    updates = updates * lr_vec
    v_new = torch.where(ok, v + updates, v)
    state = AdamState(count, torch.where(ok, mu, state.mu), torch.where(ok, nu, state.nu))
    return v_new, state, best_vec, best_val, -val


# ---------------------------------------------------------------------------
# L-BFGS (optax 0.2.6 lbfgs: scale_by_lbfgs, scale(-1), zoom linesearch)
# ---------------------------------------------------------------------------

_f = np.float64  # the linesearch's scalars: IEEE float64 with NaN/inf like jnp


def _fmin(a, b):
    return np.minimum(_f(a), _f(b))


def _fmax(a, b):
    return np.maximum(_f(a), _f(b))


class LbfgsState(NamedTuple):
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor  # (memory, P)
    diff_updates: torch.Tensor  # (memory, P)
    weights: torch.Tensor  # (memory,)
    # the accepted point's value and gradient, reused by the next step
    value: np.float64
    grad: torch.Tensor


def lbfgs_init(v: torch.Tensor, memory_size: int = 10) -> LbfgsState:
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    zeros = torch.zeros((memory_size,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    return LbfgsState(
        count=0, params=torch.zeros_like(v), updates=torch.zeros_like(v),
        diff_params=zeros, diff_updates=zeros.clone(),
        weights=torch.zeros(memory_size, dtype=v.dtype, device=v.device),
        value=_f(np.inf), grad=torch.zeros_like(v),
    )


def _lbfgs_direction(u: torch.Tensor, w: torch.Tensor, s: LbfgsState):
    """optax ``scale_by_lbfgs`` update: refresh the memory with the newest
    differences, then ``P_k u`` by the two-loop recursion.  On the device."""
    mem = s.weights.shape[0]
    memory_idx = s.count % mem
    prev_idx = (s.count - 1) % mem
    if s.count > 0:
        dp = w - s.params
        du = u - s.updates
        vd = torch.dot(du, dp)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    else:
        dp = torch.zeros_like(w)
        du = torch.zeros_like(u)
        weight = torch.zeros((), dtype=u.dtype, device=u.device)
    diff_params = s.diff_params.clone()
    diff_updates = s.diff_updates.clone()
    weights = s.weights.clone()
    diff_params[prev_idx] = dp
    diff_updates[prev_idx] = du
    weights[prev_idx] = weight
    if s.count > 0:
        num = torch.dot(du, dp)
        den = torch.sum(du * du)
        scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
    else:
        # the capped reciprocal gradient norm: a first step of length <= 1
        scale = torch.minimum(torch.ones((), dtype=u.dtype, device=u.device),
                              1.0 / torch.sqrt(torch.sum(u * u)))
    indices = [(memory_idx + i) % mem for i in range(mem)]
    vec = u
    alphas = {}
    for idx in reversed(indices):
        alpha = weights[idx] * torch.dot(diff_params[idx], vec)
        vec = vec + (-alpha) * diff_updates[idx]
        alphas[idx] = alpha
    vec = scale * vec
    for idx in indices:
        beta = weights[idx] * torch.dot(diff_updates[idx], vec)
        vec = vec + (alphas[idx] - beta) * diff_params[idx]
    return vec, s._replace(count=s.count + 1, params=w, updates=u, diff_params=diff_params,
                           diff_updates=diff_updates, weights=weights)


class _Probe(NamedTuple):
    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64


def _probe(objective, w, u, stepsize) -> _Probe:
    val, grad = value_and_grad(objective, w + float(stepsize) * u)
    value, slope = torch.stack([val, torch.dot(grad, u)]).tolist()
    return _Probe(_f(stepsize), _f(value), grad, _f(slope))


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * LS_SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - LS_APPROX_DEC_RTOL * np.abs(value_init)
    err = _fmin(_fmax(approx, delta), err)
    err = _fmax(err, 0.0)
    return _f(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = _fmax(np.abs(slope) - LS_CURV_RTOL * np.abs(slope_init), 0.0)
    return _f(np.inf) if np.isnan(err) else err


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (optax ``_cubicmin``)."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - cc * db
    v1 = fc - fa - cc * dc
    aa = (dc * dc * v0 + -(db * db) * v1) / denom
    bb = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + np.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * bb)


def _errors(line, p: _Probe):
    de = _decrease_error(p.stepsize, p.value, p.slope, line.value_init, line.slope_init)
    ce = _curvature_error(p.slope, line.slope_init)
    return de, ce, _fmax(de, ce)


def _search_interval(line, objective, w, u):
    """Algorithm 3.5 of Nocedal & Wright (optax ``_search_interval``)."""
    it = line.count
    new = _probe(objective, w, u, line.stepsize_guess if it == 0 else LS_INCREASE * line.stepsize)
    de, ce, err = _errors(line, new)
    if de <= LS_TOL:
        vars(line).update(safe_stepsize=new.stepsize, safe_value=new.value, safe_grad=new.grad)
    set_high_to_new = bool(de > 0.0) or bool(new.value >= line.value and it > 0)
    set_low_to_new = bool(new.slope >= 0.0) and not set_high_to_new
    if set_low_to_new:
        low, value_low, slope_low = new.stepsize, new.value, new.slope
        high, value_high, slope_high = line.stepsize, line.value, line.slope
    else:
        low, value_low, slope_low = line.stepsize, line.value, line.slope
        high, value_high, slope_high = new.stepsize, new.value, new.slope
    done = bool(err <= LS_TOL)
    vars(line).update(
        count=it + 1, stepsize=new.stepsize, value=new.value, grad=new.grad, slope=new.slope,
        decrease_error=de, curvature_error=ce, error=err,
        interval_found=set_high_to_new or set_low_to_new or done, done=done,
        failed=(it + 1 >= LS_MAX_STEPS) and not done,
        low=low, value_low=value_low, slope_low=slope_low,
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
    )


def _zoom_into_interval(line, objective, w, u):
    """Algorithm 3.6 of Nocedal & Wright (optax ``_zoom_into_interval``)."""
    it = line.count
    low, high = line.low, line.high
    delta = np.abs(high - low)
    left, right = _fmin(high, low), _fmax(high, low)
    cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
    too_small_int = bool(delta <= LS_INTERVAL_THRESHOLD)
    with np.errstate(all="ignore"):
        mid_cubic = _cubicmin(low, line.value_low, line.slope_low, high, line.value_high,
                              line.cubic_ref, line.value_cubic_ref)
        mid_quad = _quadmin(low, line.value_low, line.slope_low, high, line.value_high)
    if left + cubic_chk < mid_cubic < right - cubic_chk:
        middle = mid_cubic
    elif left + quad_chk < mid_quad < right - quad_chk:
        middle = mid_quad
    else:
        middle = (low + high) / 2.0
    mid = _probe(objective, w, u, middle)
    de, ce, err = _errors(line, mid)
    if de <= LS_TOL and mid.value < line.safe_value:
        vars(line).update(safe_stepsize=mid.stepsize, safe_value=mid.value, safe_grad=mid.grad)
    done = bool(err <= LS_TOL)
    set_high_to_middle = bool(de > 0.0) or bool(mid.value >= line.value_low)
    set_high_to_low = bool(mid.slope * (high - low) >= 0.0) and not set_high_to_middle
    new_high = (mid.stepsize, mid.value, mid.slope) if set_high_to_middle else (
        high, line.value_high, line.slope_high)
    if set_high_to_low:
        new_high = (low, line.value_low, line.slope_low)
    new_low = (low, line.value_low, line.slope_low) if set_high_to_middle else (
        mid.stepsize, mid.value, mid.slope)
    cubic = (high, line.value_high) if (set_high_to_middle or set_high_to_low) else (
        low, line.value_low)
    presumably_failed = (it + 1 >= LS_MAX_STEPS) or (too_small_int and line.safe_stepsize > 0.0)
    vars(line).update(
        count=it + 1, stepsize=mid.stepsize, value=mid.value, grad=mid.grad, slope=mid.slope,
        decrease_error=de, curvature_error=ce, error=err,
        done=done, failed=bool(presumably_failed) and not done,
        low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
        high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
        cubic_ref=cubic[0], value_cubic_ref=cubic[1],
    )


def _zoom_linesearch(objective, w, u, value, grad):
    """optax ``scale_by_zoom_linesearch`` update with
    ``initial_guess_strategy='one'``: returns ``(stepsize, value, grad)`` of
    the accepted point ``w + stepsize·u``."""
    value = _f(value)
    slope = _f(torch.dot(u, grad).item())
    line = SimpleNamespace(  # the zoom linesearch's state
        count=0, stepsize_guess=_f(1.0), stepsize=_f(0.0), value=value, grad=grad, slope=slope,
        value_init=value, slope_init=slope,
        decrease_error=_f(np.inf), curvature_error=_f(np.inf), error=_f(np.inf),
        interval_found=False, done=False, failed=False,
        low=_f(0.0), value_low=value, slope_low=slope, high=_f(0.0), value_high=value,
        slope_high=slope, cubic_ref=_f(0.0), value_cubic_ref=value,
        safe_stepsize=_f(0.0), safe_value=value, safe_grad=grad,
    )
    while not (line.done or line.failed):
        if line.interval_found:
            _zoom_into_interval(line, objective, w, u)
        else:
            _search_interval(line, objective, w, u)
        if line.failed and (line.safe_stepsize > 0.0 or np.isinf(line.decrease_error)):
            # fall back to the best probe with sufficient decrease (stepsize 0,
            # no move, when there was none and the last probe left the domain)
            vars(line).update(stepsize=line.safe_stepsize, value=line.safe_value, grad=line.safe_grad)
    return line.stepsize, line.value, line.grad


def guarded_lbfgs_step(objective, v, state: LbfgsState, best_vec, best_val):
    """One guarded best-seen L-BFGS step; returns ``(v, state, best_vec,
    best_val, −value)`` with host floats for the values.

    The value and gradient come from the previous linesearch when it left a
    finite value, else from a fresh evaluation.  A non-finite value or
    gradient zeroes the gradient the optimizer sees and holds the
    parameters, as does a non-finite new iterate.
    """
    if np.isfinite(state.value):
        val, grad = state.value, state.grad
    else:
        val_t, grad = value_and_grad(objective, v)
        val = _f(val_t.item())
    ok = bool(np.isfinite(val)) and bool(torch.isfinite(grad).all())
    if ok and val < best_val:
        best_vec, best_val = v, val
    grad_s = grad if ok else torch.zeros_like(grad)
    direction, state = _lbfgs_direction(grad_s, v, state)
    direction = -1.0 * direction
    stepsize, ls_value, ls_grad = _zoom_linesearch(objective, v, direction, val, grad_s)
    v_new = v + float(stepsize) * direction
    if not (ok and bool(torch.isfinite(v_new).all())):
        v_new = v
    state = state._replace(value=ls_value, grad=ls_grad)
    return v_new, state, best_vec, best_val, -val


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _build_lr_vec(lr, n_params: int, groups, device, dtype) -> torch.Tensor:
    lv = np.full((n_params,), float(lr))
    if groups:
        for idx, g_lr in groups.items():
            lv[idx] = g_lr
    return torch.as_tensor(lv, dtype=dtype, device=device)


def fit_map(
    objective: Callable,
    init_vec: torch.Tensor,
    n_iters: int = 1000,
    lr: float = 2e-1,
    lr_groups: dict | None = None,
    chunk: int = 100,
    err_opt: float | None = None,
    checkpoint_fn: Callable | None = None,
    method: str = "adam",
    lbfgs_memory: int = 10,
) -> MapResult:
    """Run MAP optimization from ``init_vec`` (on its device, in its dtype).

    ``n_iters`` steps in chunks of ``chunk``; after each chunk
    ``checkpoint_fn(best_vec, iteration)`` is called and, with ``err_opt``,
    the run stops once the chunk-mean objective moves by less than
    ``err_opt``.  ``method="lbfgs"`` ignores ``lr``/``lr_groups`` (the
    linesearch sets the step).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want 'adam' or 'lbfgs')")
    vec = init_vec.detach()
    best_vec = vec
    if method == "lbfgs":
        state = lbfgs_init(vec, int(lbfgs_memory))
        best_val = _f(np.inf)
    else:
        state = adam_init(vec)
        lr_vec = _build_lr_vec(lr, vec.shape[0], lr_groups, vec.device, vec.dtype)
        best_val = torch.full((), float("inf"), dtype=vec.dtype, device=vec.device)
    hists = []
    prev_mean = None
    it = 0
    converged = False
    while it < n_iters:
        steps = min(chunk, n_iters - it)
        targets = []
        for _ in range(steps):
            if method == "lbfgs":
                vec, state, best_vec, best_val, t = guarded_lbfgs_step(
                    objective, vec, state, best_vec, best_val)
            else:
                vec, state, best_vec, best_val, t = guarded_adam_step(
                    objective, lr_vec, vec, state, best_vec, best_val)
            targets.append(t)
        targets = (torch.as_tensor(np.array(targets, np.float64), dtype=vec.dtype, device=vec.device)
                   if method == "lbfgs" else torch.stack(targets))
        hists.append(targets)
        it += steps
        if checkpoint_fn is not None:
            checkpoint_fn(best_vec, it)
        if err_opt is not None:
            cur_mean = float(torch.mean(targets))
            if prev_mean is not None and abs(cur_mean - prev_mean) < err_opt:
                converged = True
                break
            prev_mean = cur_mean
    # the post-update final iterate is never scored inside the loop; give it
    # one chance to beat the running best
    with torch.no_grad():
        final_val = float(objective(vec))
    if np.isfinite(final_val) and final_val < float(best_val):
        best_vec = vec
    return MapResult(
        vec=best_vec,
        target_hist=torch.cat(hists) if hists else torch.zeros((0,), dtype=vec.dtype, device=vec.device),
        n_iters=it,
        converged=converged,
    )


def multi_start_map(objective: Callable, inits: dict, **fit_kwargs):
    """Fit from several inits and keep the best by final objective.

    Mirrors the reference's mpisim multi-start (failures score +inf,
    ``Nonseparable_model_mpisim.py:322-348``), but a failed start is logged
    and its error returned under the ``"__errors__"`` key of the results.
    Returns ``(best_name, best_result, results)``.
    """
    results: dict = {}
    scores: dict[str, float] = {}
    errors: dict[str, str] = {}
    for name, init_vec in inits.items():
        try:
            res = fit_map(objective, init_vec, **fit_kwargs)
            with torch.no_grad():
                final = float(objective(res.vec))
            if not np.isfinite(final):
                raise FloatingPointError("non-finite objective")
            results[name] = res
            scores[name] = final
        except Exception as exc:  # a failed start scores +inf, like the reference
            results[name] = None
            scores[name] = float("inf")
            errors[name] = f"{type(exc).__name__}: {exc}"
            logging.getLogger(__name__).warning("MAP start %r failed: %s", name, errors[name])
    best = min(scores, key=scores.get)
    if results[best] is None:
        raise RuntimeError(f"every MAP start failed: {errors}")
    if errors:
        results["__errors__"] = errors
    return best, results[best], results
