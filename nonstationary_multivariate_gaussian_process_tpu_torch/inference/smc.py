"""Adaptive tempered SMC: a particle population follows the prior-to-posterior
path.

Counterpart of the JAX package's ``inference/smc.py``.  A population of
``n_particles`` starts as exact draws from the reference ``pi_0 = N(ref_mean,
diag(ref_scale^2))`` (standard normal by default: the exact prior of the
whitened latent-GP blocks, :mod:`.whiten`) and follows the geometric path
``pi_b ∝ pi_0^(1-b) pi_1^b`` to the posterior ``pi_1 ∝ exp(-U)``.  Each stage

* reweights by ``exp(-(b' - b)(U - R))`` (``R`` the reference potential;
  dead particles, whose ``U - R`` is not finite, get weight 0), choosing the
  next ``b'`` by a 32-step bisection so that the conditional ESS stays at
  ``target_cess`` (1 is taken when it already qualifies, and ``b`` advances
  at least ``min_beta_step``);
* resamples (systematic by default; or stratified, residual, multinomial),
  every stage, or with ``resample_ess < 1`` only when the carried weights'
  ESS drops below it and at the stage that reaches ``b = 1``; waste-free
  stages (``waste_free = L``) resample ``n / L`` ancestors;
* mutates by ``n_mutations`` batched HMC sweeps (``L - 1`` waste-free,
  whose chains' every state joins the next population), optionally with
  2-stage delayed rejection (``dr_reduction``), in the metric-whitened
  space ``q = mu + L z`` of the population's per-coordinate scales
  (``metric="diag"``) or its shrunk covariance's Cholesky factor
  (``metric="full"``), with a shared step size pre-scaled by
  ``sqrt(b / b')`` and adapted Robbins-Monro toward ``target_accept``
  (``adapt_mutations`` stops a stage's sweeps once the population has moved
  far enough).

``logz`` telescopes the stages' mean weights into ``log ∫ exp(-U(q)) dq``
(the evidence; add ``Whitener.logdet()`` for a whitened potential).

The port runs the JAX stage's arithmetic step for step, eagerly, in one
host loop over stages: ``dispatch="device"`` and ``"host"`` run the same
loop and give the same draws.  The population's potentials are either one
batched evaluation (``potential_batched=True``: ``potential_fn`` maps (B, P)
to (B,), and the gradient of the rows' sum is each row's gradient, JAX's
ones-vector VJP) or, for a per-vector ``potential_fn``, one evaluation per
row (the row route): the same values, one row at a time.

Noise.  With a ``torch.Generator`` (on the population's device) the draws
come in this order: first ``q0 = ref_mean + ref_scale · normal((n, P))``
(none when ``init_particles`` is given); then each stage (polish stages
too) draws its resampler's uniform(s), one scalar for ``"systematic"`` and
``"residual"``, ``(n_out,)`` for ``"stratified"`` and ``"multinomial"``
(``n_out`` the population, or its ``n / L`` ancestors waste-free), even
where a gated stage does not resample; then each sweep it runs draws the
momenta ``(nr, P)`` (``nr`` = ``n_out``) and then its uniforms ``(nr,)``, or
``(nr, 2)`` with delayed rejection.  A gated run that ends short of ``b =
1`` draws the uniform(s) of one more resample last.

With ``noise=`` an object replaces the generator, with the methods

* ``init(n, dim)`` → standard normals (n, dim),
* ``stage(i, res_shape, n_sweeps, mom_shape, acc_shape)`` → ``(u_res,
  sweeps)`` for stage ``i`` (0-based, polish stages counted), ``sweeps[j]``
  being ``(momenta, uniforms)`` of sweep ``j`` (an adaptive stage may use
  fewer than ``n_sweeps``),
* ``final(res_shape)`` → the truncation resample's uniform(s),

so that the tests can replay JAX's key threading: ``key, k_init =
split(key)``; a stage ``key, k_res, k_mut = split(key, 3)``, the
resampler's ``uniform(k_res, res_shape)``, ``split(k_mut, n_sweeps)`` for
the sweeps and ``k_mom, k_acc = split(k)`` in each; the truncation
resample's ``uniform(key, res_shape)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import settings
from .drhmc import _log1m_exp
from .map import value_and_grad


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (N, P) unweighted particles at beta_final
    logz: torch.Tensor  # log integral of exp(-potential) (see module docstring)
    n_stages: torch.Tensor  # stage calls used (tempering + any beta=1 polish)
    beta_final: torch.Tensor  # 1.0 when the path completed within max_stages
    betas: torch.Tensor  # (max_stages,) beta after each stage (padded with 1)
    cess: torch.Tensor  # (max_stages,) conditional-ESS fraction per stage
    accept: torch.Tensor  # (max_stages,) mean mutation accept prob per stage
    step_sizes: torch.Tensor  # (max_stages,) step size in effect per stage
    potentials: torch.Tensor  # (N,) potential at the final particles
    resampled: torch.Tensor | None = None  # (max_stages,) 1.0 where the stage resampled


def _lse(x: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(x, dim=0)


def _ess_fraction(log_w: torch.Tensor) -> torch.Tensor:
    """ESS(w)/N = exp(2 lse(lw) - lse(2 lw)) / N for unnormalized log-weights."""
    n = log_w.shape[0]
    return torch.exp(2.0 * _lse(log_w) - _lse(2.0 * log_w)) / n


def _cess_fraction(log_w: torch.Tensor, dlw: torch.Tensor) -> torch.Tensor:
    """Conditional ESS fraction under carried weights (Zhou/Johansen/Aston):
    ``(sum w u)^2 / ((sum w) (sum w u^2))`` with ``w = exp(log_w)``, ``u =
    exp(dlw)``; :func:`_ess_fraction` of ``dlw`` at uniform weights."""
    return torch.exp(2.0 * _lse(log_w + dlw) - _lse(log_w) - _lse(log_w + 2.0 * dlw))


def _cumulative(log_w: torch.Tensor) -> torch.Tensor:
    w = torch.exp(log_w - _lse(log_w))
    return torch.cumsum(w, dim=0)


def _arange(n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=ref.dtype, device=ref.device)


def _strata_resample(u, log_w: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Systematic and stratified resampling: ``n_out`` (default the
    population; waste-free stages draw ``N / L``) points, one a stratum,
    offset by ``u``: one uniform shared by every stratum (systematic, ``u``
    a scalar) or one of its own each (stratified, ``u`` (n_out,))."""
    n = log_w.shape[0] if n_out is None else int(n_out)
    cum = _cumulative(log_w)
    pts = (u + _arange(n, cum)) / n
    return torch.clamp(torch.searchsorted(cum, pts), 0, log_w.shape[0] - 1)


def _multinomial_resample(u, log_w: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Multinomial resampling: ``n_out`` iid draws ``u`` (n_out,)."""
    cum = _cumulative(log_w)
    return torch.clamp(torch.searchsorted(cum, u), 0, log_w.shape[0] - 1)


def _residual_resample(u, log_w: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Residual-systematic resampling (Liu & Chen 1998) in fixed shapes:
    ``floor(n w_i)`` offspring each, the ``R = n - sum floor(n w)`` others
    systematic (one uniform ``u``) from the residual weights, scattered into
    counts and expanded to sorted indices by one ``searchsorted``."""
    n_in = log_w.shape[0]
    n = n_in if n_out is None else int(n_out)
    w = torch.exp(log_w - _lse(log_w))
    nw = n * w
    fl = torch.floor(nw)
    res = nw - fl
    # fl entries are exact integer-valued floats, so r is exact too
    r = torch.clamp(torch.tensor(float(n), dtype=w.dtype, device=w.device) - torch.sum(fl), min=0.0)
    cum = torch.cumsum(res, dim=0)
    cum = cum / torch.clamp(cum[-1], min=torch.finfo(w.dtype).tiny)
    j = _arange(n, w)
    pts = (u + j) / torch.clamp(r, min=1.0)
    idx_res = torch.clamp(torch.searchsorted(cum, pts), 0, n_in - 1)
    valid = (j < r).to(w.dtype)
    counts = fl + torch.zeros_like(fl).index_add_(0, idx_res, valid)
    out = torch.searchsorted(torch.cumsum(counts, dim=0), j + 0.5)
    return torch.clamp(out, 0, n_in - 1)


_RESAMPLERS = {
    "systematic": _strata_resample,
    "stratified": _strata_resample,
    "residual": _residual_resample,
    "multinomial": _multinomial_resample,
}
#: The resamplers that draw one uniform (the others one per output).
_ONE_UNIFORM = ("systematic", "residual")


def _res_shape(resample: str, n_out: int) -> tuple:
    return () if resample in _ONE_UNIFORM else (n_out,)


class _GeneratorNoise:
    """The noise source of a ``torch.Generator``, in the module docstring's
    order; a stage's sweeps are drawn when first read, in order."""

    def __init__(self, generator: torch.Generator, dtype, device):
        if generator.device.type != torch.device(device).type:
            raise ValueError(f"the generator lives on {generator.device}, the population on {device}")
        self.gen, self.dtype, self.device = generator, dtype, device

    def _rand(self, shape):
        return torch.rand(shape, generator=self.gen, dtype=self.dtype, device=self.device)

    def init(self, n, dim):
        return torch.randn((n, dim), generator=self.gen, dtype=self.dtype, device=self.device)

    def stage(self, i, res_shape, n_sweeps, mom_shape, acc_shape):
        u = self._rand(res_shape)
        drawn = []

        class Sweeps:
            def __getitem__(_, j):
                while len(drawn) <= j:
                    z = torch.randn(mom_shape, generator=self.gen, dtype=self.dtype, device=self.device)
                    drawn.append((z, self._rand(acc_shape)))
                return drawn[j]

        return u, Sweeps()

    def final(self, res_shape):
        return self._rand(res_shape)


class _Stage:
    """One tempering stage, (reweight -> bisect -> [resample] -> mutate), as
    JAX's ``_build_stage`` builds it, for ``n`` particles of ``dim``."""

    def __init__(self, potential_fn, n, dim, dtype, device, ref_mean, ref_scale, *, n_mutations, n_leapfrog,
                 n_bisect, dr_reduction, target_cess, target_accept, adapt_rate, min_beta_step, metric, shrink,
                 waste_free, potential_batched, adapt_mutations, msjd_frac, resample_ess, resample):
        self.potential_fn, self.n, self.dim = potential_fn, n, dim
        self.dtype, self.device = dtype, device
        self.ref_mean, self.ref_scale = ref_mean, ref_scale
        self.n_mutations, self.n_leapfrog, self.n_bisect = n_mutations, n_leapfrog, n_bisect
        self.dr_reduction = dr_reduction
        scalar = lambda v: torch.tensor(v, dtype=dtype, device=device)
        self.target_cess, self.target_accept = scalar(target_cess), scalar(target_accept)
        self.adapt_rate, self.min_beta_step = scalar(adapt_rate), scalar(min_beta_step)
        self.one, self.zero = scalar(1.0), scalar(0.0)
        self.log_n = torch.log(scalar(float(n)))
        self.big = scalar(torch.finfo(dtype).max / 8)
        self.metric, self.shrink = metric, shrink
        self.waste_free, self.batched = waste_free, potential_batched
        self.adapt_mutations, self.msjd_frac = adapt_mutations, msjd_frac
        self.resample_ess, self.resample = float(resample_ess), resample
        self.gated = self.resample_ess < 1.0
        if self.gated and waste_free:
            raise ValueError("resample_ess < 1 is incompatible with waste_free "
                             "(waste-free stages must resample their ancestors)")
        self.res_fn = _RESAMPLERS[resample]
        self.n_out = n // waste_free if waste_free else n
        self.n_sweeps = waste_free - 1 if waste_free else n_mutations

    # -- potentials ---------------------------------------------------------

    def k_ref(self, q):
        """Reference potential over the trailing axis."""
        z = (q - self.ref_mean) / self.ref_scale
        return 0.5 * torch.sum(z * z, dim=-1)

    def u_batch(self, qs):
        with torch.no_grad():
            if self.batched:
                return self.potential_fn(qs)
            return torch.stack([self.potential_fn(q) for q in qs])

    def u_b(self, qs, b):
        with torch.no_grad():
            if self.batched:
                return (1.0 - b) * self.k_ref(qs) + b * self.potential_fn(qs)
            return torch.stack([(1.0 - b) * self.k_ref(q) + b * self.potential_fn(q) for q in qs])

    def val_grad_b(self, qs, b):
        if self.batched:
            with torch.enable_grad():
                q = qs.detach().requires_grad_(True)
                u = (1.0 - b) * self.k_ref(q) + b * self.potential_fn(q)
                (g,) = torch.autograd.grad(u.sum(), q)
            return u.detach(), g
        pot = lambda v: (1.0 - b) * self.k_ref(v) + b * self.potential_fn(v)
        pairs = [value_and_grad(pot, q) for q in qs]
        return torch.stack([u for u, _ in pairs]), torch.stack([g for _, g in pairs])

    # -- mutation -----------------------------------------------------------

    def propose(self, zs, p, b, eps, lin):
        """Leapfrog(eps, n_leapfrog) and a momentum flip on the batch, in the
        metric-whitened space; returns the proposal, the flipped momentum and
        each row's total energy."""
        mu, lmul, ltmul, _ = lin

        def val_grad_z(z):
            u, gq = self.val_grad_b(mu + lmul(z), b)
            return u, ltmul(gq)

        g = val_grad_z(zs)[1]
        p = p - 0.5 * eps * g
        z = zs + eps * p
        for _ in range(self.n_leapfrog - 1):
            p = p - eps * val_grad_z(z)[1]
            z = z + eps * p
        u, g = val_grad_z(z)
        p = p - 0.5 * eps * g
        h = u + 0.5 * torch.sum(p * p, dim=1)
        return z, -p, h

    def hmc_sweep(self, zs, b, eps, lin, mom, unif):
        """One batched HMC (or 2-stage delayed-rejection) step on every row;
        returns the rows and the mean stage-1 accept probability."""
        mu, lmul = lin[0], lin[1]
        p = mom
        h0 = self.u_b(mu + lmul(zs), b) + 0.5 * torch.sum(p * p, dim=1)
        z1, _, h1 = self.propose(zs, p, b, eps, lin)
        ninf = torch.full_like(h1, -math.inf)
        la1 = torch.where(torch.isfinite(h1), torch.clamp(h0 - h1, max=0.0), ninf)
        if self.dr_reduction <= 0:
            accept = torch.log(unif) < la1
            return torch.where(accept[:, None], z1, zs), torch.mean(torch.exp(la1))
        acc1 = torch.log(unif[:, 0]) < la1
        # stage 2 from the same (z, p) at eps/red; ghost stage 1 from (z2, p2)
        eps2 = eps / torch.tensor(self.dr_reduction, dtype=self.dtype, device=self.device)
        z2, p2, h2 = self.propose(zs, p, b, eps2, lin)
        _, _, hg = self.propose(z2, p2, b, eps, lin)
        la1_ghost = torch.where(torch.isfinite(hg), torch.clamp(h2 - hg, max=0.0), ninf)
        num = -h2 + _log1m_exp(la1_ghost)
        den = -h0 + _log1m_exp(la1)
        ok = torch.isfinite(h2) & torch.isfinite(num) & torch.isfinite(den)
        la2 = torch.where(ok, torch.clamp(num - den, max=0.0), ninf)
        acc2 = (~acc1) & (torch.log(unif[:, 1]) < la2)
        zs = torch.where(acc1[:, None], z1, torch.where(acc2[:, None], z2, zs))
        # adaptation tracks the stage-1 rate: DR's retries are a safety net
        return zs, torch.mean(torch.exp(la1))

    # -- metric -------------------------------------------------------------

    def metric_arrays(self, qs, log_w=None):
        """(mu, sd) for diag, (mu, shrunk covariance) for full; weighted by
        ``log_w`` (waste-free stages, gated stages that keep their weights)."""
        if log_w is not None:
            w = torch.exp(log_w - _lse(log_w))
            mu = w @ qs
            xc = qs - mu
            if self.metric == "diag":
                return mu, torch.sqrt(torch.clamp(w @ (xc * xc), min=1e-8))
            cov = (xc * w[:, None]).T @ xc
        else:
            mu = torch.mean(qs, dim=0)
            xc = qs - mu
            if self.metric == "diag":
                return mu, torch.sqrt(torch.clamp(torch.var(qs, dim=0, correction=0), min=1e-8))
            cov = xc.T @ xc / (qs.shape[0] - 1)
        dvar = torch.clamp(torch.diagonal(cov), min=1e-8)
        cov = (1.0 - self.shrink) * cov + self.shrink * torch.diag(dvar)
        cov = cov + 1e-6 * torch.mean(dvar) * torch.eye(self.dim, dtype=self.dtype, device=self.device)
        return mu, cov

    def lin_from(self, mu, stat):
        """(mu, L@, L.T@, L^-1@) from the metric statistics."""
        if self.metric == "diag":
            sd = stat
            return mu, lambda z: z * sd, lambda g: g * sd, lambda x: x / sd
        l_cov, info = torch.linalg.cholesky_ex(stat)
        l_cov = torch.where(info == 0, l_cov, torch.full_like(l_cov, math.nan))  # JAX's NaN factor
        return (mu, lambda z: z @ l_cov.T, lambda g: g @ l_cov,
                lambda x: torch.linalg.solve_triangular(l_cov, x.T, upper=False).T)

    def make_lin(self, qs, log_w=None):
        return self.lin_from(*self.metric_arrays(qs, log_w))

    # -- schedule -----------------------------------------------------------

    def next_beta(self, b, v, log_w=None):
        """Largest b' in (b, 1] whose incremental-weight CESS >= target."""

        def cess(b2):
            dlw = -(b2 - b) * v
            return _ess_fraction(dlw) if log_w is None else _cess_fraction(log_w, dlw)

        lo, hi = b, self.one
        for _ in range(self.n_bisect):
            mid = 0.5 * (lo + hi)
            ok = cess(mid) >= self.target_cess
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        b2 = torch.where(cess(self.one) >= self.target_cess, self.one, lo)
        return torch.minimum(self.one, torch.maximum(b2, b + self.min_beta_step))

    def __call__(self, qs, lw, b, logz, log_eps, draws):
        """One stage; ``draws = (u_res, sweeps)``.  Returns (qs, lw, b, logz,
        log_eps, cess fraction, mean accept, resampled)."""
        u_res, sweeps = draws
        n = self.n
        v = self.u_batch(qs) - self.k_ref(qs)
        v = torch.where(torch.isfinite(v), v, self.big)  # dead particles get weight 0
        if self.gated:
            b2 = self.next_beta(b, v, lw)
            dlw = -(b2 - b) * v
            cess_frac = _cess_fraction(lw, dlw)
            inc = _lse(lw + dlw)  # lse(lw) = 0: the exact telescope
            logz = logz + inc
            lw2 = lw + dlw - inc  # renormalized combined weights
            do_res = bool((_ess_fraction(lw2) < self.resample_ess) | (b2 >= 1.0))
        else:
            b2 = self.next_beta(b, v)
            dlw = -(b2 - b) * v
            logz = logz + _lse(dlw) - self.log_n
            cess_frac = _ess_fraction(dlw)
            lw2 = dlw  # resampling weights, uniform carry untouched

        res = self.one
        lw_out = lw
        if self.waste_free:
            # Dau & Chopin (2022): M = N/L ancestors; the union of their
            # length-L chains is the next population.  The metric comes from
            # the weighted full pre-resample population.
            anc = qs[self.res_fn(u_res, lw2, self.n_out)]
            lin = self.make_lin(qs, log_w=lw2)
            zs = lin[3](anc - lin[0])
        elif self.gated:
            if do_res:
                qs_full = qs[self.res_fn(u_res, lw2)]
                lw_out = torch.full((n,), -1.0, dtype=self.dtype, device=self.device) * self.log_n
                lin = self.make_lin(qs_full)
            else:
                # mutate the weighted population, metric from its weights
                qs_full, lw_out, res = qs, lw2, self.zero
                lin = self.make_lin(qs, log_w=lw2)
            zs = lin[3](qs_full - lin[0])
        else:
            qs_full = qs[self.res_fn(u_res, lw2)]
            lin = self.make_lin(qs_full)
            zs = lin[3](qs_full - lin[0])

        # feed-forward step scaling: the likelihood Hessian enters as b·H, so
        # the stable step shrinks ~1/sqrt(b); Robbins-Monro corrects the rest
        log_eps = log_eps + torch.where(
            b > 0, 0.5 * (torch.log(torch.maximum(b, self.min_beta_step)) - torch.log(b2)), self.zero)

        if self.adapt_mutations and not self.waste_free:
            # stop once the mean squared displacement from the stage's start
            # crosses msjd_frac of full decorrelation (2·dim in z)
            z0 = zs
            thresh = self.msjd_frac * 2.0 * self.dim
            n_done, acc_sum, done = 0, self.zero, False
            while not done and n_done < self.n_sweeps:
                zs, acc = self.hmc_sweep(zs, b2, torch.exp(log_eps), lin, *sweeps[n_done])
                log_eps = log_eps + self.adapt_rate * (acc - self.target_accept)
                d = torch.mean(torch.sum((zs - z0) ** 2, dim=1))
                n_done, acc_sum, done = n_done + 1, acc_sum + acc, bool(d >= thresh)
            qs = lin[0] + lin[1](zs)
            mean_acc = acc_sum / max(n_done, 1)
            return qs, lw_out, b2, logz, log_eps, cess_frac, mean_acc, res

        states, accs = [zs], []
        for j in range(self.n_sweeps):
            zs, acc = self.hmc_sweep(zs, b2, torch.exp(log_eps), lin, *sweeps[j])
            log_eps = log_eps + self.adapt_rate * (acc - self.target_accept)
            states.append(zs)
            accs.append(acc)
        if self.waste_free:
            # chain-major union (ancestor first): (M, L, P) -> (N, P)
            allz = torch.stack(states, dim=0).transpose(0, 1).reshape(-1, self.dim)
            qs = lin[0] + lin[1](allz)
        else:
            qs = lin[0] + lin[1](zs)
        return qs, lw_out, b2, logz, log_eps, cess_frac, torch.mean(torch.stack(accs)), res


def _logz0(dim: int, ref_scale: torch.Tensor) -> torch.Tensor:
    """log normalizer of the reference: P/2 log 2pi + sum log scale."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=ref_scale.dtype, device=ref_scale.device)
    return 0.5 * dim * torch.log(two_pi) + torch.sum(torch.log(ref_scale))


def _check_waste_free(waste_free, n: int) -> int:
    """The waste-free chain length L: 0 disables; else L >= 2 dividing N."""
    l = int(waste_free)
    if l == 0:
        return 0
    if l < 2:
        raise ValueError(f"waste_free wants chain length >= 2, got {l}")
    if n % l:
        raise ValueError(f"waste_free={l} must divide n_particles={n} (M = N/L ancestor chains)")
    return l


def _noise_arrays(noise, dtype, device):
    """Wrap a ``noise=`` object so its arrays come back as tensors of the
    population's dtype and device, shape-checked."""
    as_t = lambda a, shape: _shaped(torch.as_tensor(a, dtype=dtype, device=device), shape)

    class Source:
        def init(self, n, dim):
            return as_t(noise.init(n, dim), (n, dim))

        def stage(self, i, res_shape, n_sweeps, mom_shape, acc_shape):
            u, sweeps = noise.stage(i, res_shape, n_sweeps, mom_shape, acc_shape)

            class Sweeps:
                def __getitem__(_, j):
                    z, a = sweeps[j]
                    return as_t(z, mom_shape), as_t(a, acc_shape)

            return as_t(u, res_shape), Sweeps()

        def final(self, res_shape):
            return as_t(noise.final(res_shape), res_shape)

    return Source()


def _shaped(t: torch.Tensor, shape) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"noise: expected an array of shape {tuple(shape)}, got {tuple(t.shape)}")
    return t


def smc_sample(
    potential_fn: Callable,
    dim: int,
    generator: torch.Generator | None = None,
    n_particles: int = 1024,
    *,
    n_mutations: int = 5,
    n_leapfrog: int = 10,
    max_stages: int = 64,
    target_cess: float = 0.5,
    target_accept: float = 0.65,
    step_size: float = 0.1,
    adapt_rate: float = 0.3,
    min_beta_step: float = 1e-5,
    n_bisect: int = 32,
    dr_reduction: float = 0.0,
    metric: str = "diag",
    shrink: float = 0.1,
    n_polish: int = 0,
    waste_free: int = 0,
    potential_batched: bool = False,
    adapt_mutations: bool = False,
    msjd_frac: float = 0.5,
    resample_ess: float = 1.0,
    resample: str = "systematic",
    ref_mean=None,
    ref_scale=None,
    init_particles=None,
    dtype=None,
    device=None,
    dispatch: str = "device",
    progress=None,
    noise=None,
) -> SMCResult:
    """Sample ``exp(-potential_fn)`` by adaptive tempered SMC (JAX
    ``smc_sample``, its arguments and checks).

    The pairing is the whitened space, whose standard-normal reference is
    the exact prior of the latent-GP blocks::

        w = whiten.make_whitener("gnmgp", x, n, m)
        r = smc.smc_sample(w.wrap(nlp), w.n_params, generator, 1024)
        draws = w.from_white_batch(r.particles)

    The population lives on ``device`` (default: the generator's, else
    ``init_particles``'s, else ``settings.default_device()``) in ``dtype``
    (default ``settings.dtype``).  Returns unweighted particles, the log
    normalizing constant and the per-stage schedule; check ``beta_final ==
    1``.  ``n_stages`` counts every stage run, polish stages beyond
    ``max_stages`` too, which the (padded) histories do not record.
    ``potential_batched=True`` declares a (B, P) → (B,) ``potential_fn``;
    else each row is its own evaluation.  ``dispatch`` ("device" or "host")
    is accepted for JAX's signature: both run the same stage loop, and
    ``progress`` (a callable) receives a dict per stage.  Noise comes from
    ``generator`` or ``noise`` (module docstring).  ``smc_sample_sharded``
    is not ported.
    """
    if adapt_mutations and waste_free:
        raise ValueError("adapt_mutations is incompatible with waste_free "
                         "(the union keeps every state of a fixed-length chain)")
    if not 0.0 < float(resample_ess) <= 1.0:
        raise ValueError(f"resample_ess must be in (0, 1], got {resample_ess}")
    if resample not in _RESAMPLERS:
        raise ValueError(f"unknown resample {resample!r} (want one of {sorted(_RESAMPLERS)})")
    dtype = dtype or settings.dtype
    if device is None:
        if generator is not None:
            device = generator.device
        elif isinstance(init_particles, torch.Tensor):
            device = init_particles.device
        else:
            device = settings.resolve_device(None)
    device = torch.device(device)
    dim = int(dim)
    if noise is not None:
        source = _noise_arrays(noise, dtype, device)
    elif generator is not None:
        source = _GeneratorNoise(generator, dtype, device)
    else:
        raise ValueError("smc_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    as_vec = lambda v, fill: (torch.full((dim,), fill, dtype=dtype, device=device) if v is None
                              else torch.as_tensor(v, dtype=dtype, device=device).expand(dim).clone())
    ref_mean, ref_scale = as_vec(ref_mean, 0.0), as_vec(ref_scale, 1.0)
    if init_particles is None:
        n_p = int(n_particles)
        if waste_free:
            n_p += (-n_p) % int(waste_free)  # exchangeable: extras only help
        q0 = ref_mean + ref_scale * source.init(n_p, dim)
    else:
        q0 = torch.as_tensor(init_particles, dtype=dtype, device=device)
    if dispatch not in ("device", "host"):
        raise ValueError(f"unknown dispatch {dispatch!r} (want 'device' or 'host')")
    if metric not in ("diag", "full"):
        raise ValueError(f"unknown metric {metric!r} (want 'diag' or 'full')")
    n = q0.shape[0]
    stage = _Stage(
        potential_fn, n, dim, dtype, device, ref_mean, ref_scale,
        n_mutations=int(n_mutations), n_leapfrog=int(n_leapfrog), n_bisect=int(n_bisect),
        dr_reduction=float(dr_reduction), target_cess=target_cess, target_accept=target_accept,
        adapt_rate=adapt_rate, min_beta_step=min_beta_step, metric=metric, shrink=float(shrink),
        waste_free=_check_waste_free(waste_free, n), potential_batched=bool(potential_batched),
        adapt_mutations=bool(adapt_mutations), msjd_frac=float(msjd_frac),
        resample_ess=float(resample_ess), resample=resample,
    )
    res_shape = _res_shape(resample, stage.n_out)
    mom_shape = (stage.n_out, dim)
    acc_shape = (stage.n_out, 2) if float(dr_reduction) > 0 else (stage.n_out,)
    max_stages = int(max_stages)

    hist = np.zeros((5, max_stages), dtype=torch.empty((), dtype=dtype).numpy().dtype)
    hist[0] = 1.0  # betas pad with 1
    qs, b, logz = q0, stage.zero, stage.zero
    lw = torch.full((n,), -1.0, dtype=dtype, device=device) * stage.log_n
    log_eps = torch.log(torch.tensor(float(step_size), dtype=dtype, device=device))
    i = 0

    def run_stage():
        nonlocal qs, lw, b, logz, log_eps
        draws = source.stage(i, res_shape, stage.n_sweeps, mom_shape, acc_shape)
        qs, lw, b, logz, log_eps, cess_frac, acc, res = stage(qs, lw, b, logz, log_eps, draws)
        row = (float(b), float(cess_frac), float(acc), float(torch.exp(log_eps)), float(res))
        if i < max_stages:
            hist[:, i] = row
        return row

    while i < max_stages and float(b) < 1.0:
        beta, cess_frac, acc, eps, res = run_stage()
        i += 1
        if progress is not None:
            progress({"stage": i, "beta": beta, "cess": cess_frac, "accept": acc, "step_size": eps,
                      "resampled": bool(res)})
    for jp in range(int(n_polish) if float(b) >= 1.0 else 0):
        _, _, acc, eps, _ = run_stage()
        i += 1
        if progress is not None:
            progress({"polish": jp + 1, "accept": acc, "step_size": eps})
    if float(resample_ess) < 1.0 and float(b) < 1.0:
        # a gated run truncated short of beta = 1 carries non-uniform
        # weights: one final resample returns an unweighted population
        qs = qs[stage.res_fn(source.final(_res_shape(resample, n)), lw)]
    as_t = lambda a: torch.as_tensor(a, device=device)
    return SMCResult(
        particles=qs,
        logz=logz + _logz0(dim, ref_scale),
        n_stages=torch.tensor(i, dtype=torch.int32, device=device),
        beta_final=b,
        betas=as_t(hist[0]),
        cess=as_t(hist[1]),
        accept=as_t(hist[2]),
        step_sizes=as_t(hist[3]),
        potentials=stage.u_batch(qs),
        resampled=as_t(hist[4]),
    )


def smc_sample_runs(potential_fn: Callable, dim: int, generator: torch.Generator | None, n_runs: int,
                    n_particles: int = 1024, noise=None, **kwargs) -> SMCResult:
    """``n_runs`` independent :func:`smc_sample` runs, one after another from
    ``generator`` (or from ``noise``, a sequence of ``n_runs`` noise
    objects); every field gains a leading (n_runs,) axis.  Feed
    ``particles`` to :func:`smc_ess_estimate`."""
    runs = [smc_sample(potential_fn, dim, generator, n_particles,
                       noise=None if noise is None else noise[r], **kwargs) for r in range(int(n_runs))]
    return SMCResult(*(torch.stack([getattr(r, f) for r in runs]) for f in SMCResult._fields))


def smc_ess_estimate(particle_runs, slots=None) -> dict:
    """Effective samples from R independent runs, per slot (JAX
    ``smc_ess_estimate``): ``N_eff(f) = Var_pooled(f) / Var_runs(mean_r f)``
    for each coordinate in ``slots`` (default every 7th); min, median and the
    harmonic-pooled ``pooled_ess``."""
    if isinstance(particle_runs, torch.Tensor):
        particle_runs = particle_runs.detach().cpu().numpy()
    runs = np.asarray(particle_runs)  # (R, N, P)
    r, n, p = runs.shape
    if slots is None:
        slots = range(0, p, 7)
    slots = list(slots)
    pooled = runs.reshape(r * n, p)[:, slots]
    var_post = pooled.var(axis=0, ddof=1)  # (S,)
    run_means = runs[:, :, slots].mean(axis=1)  # (R, S)
    var_means = run_means.var(axis=0, ddof=1)  # (S,)
    n_eff = var_post / np.maximum(var_means, 1e-300)
    return {
        "min_ess": float(np.min(n_eff)),
        "median_ess": float(np.median(n_eff)),
        "pooled_ess": float(1.0 / np.mean(1.0 / n_eff)),
        "n_runs": int(r),
        "n_particles": int(n),
    }
