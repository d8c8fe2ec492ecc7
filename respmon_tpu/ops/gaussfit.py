"""Vectorized Gaussian curve fitting (MINPACK-style trust-region LM).

The reference fits ``gaussian(x, ampl, center, dev) = ampl*exp(-(x-center)^2 /
(2*dev^2))`` to a window around each candidate peak via
``peakutils.gaussian_fit(ti, datai, center_only=False)`` (base.py:327), which
wraps ``scipy.optimize.curve_fit`` (MINPACK lmdif) with initial guess
``[max(y), x[0], (x[1]-x[0])*5]``; a ``RuntimeError`` (no convergence) drops
the peak (base.py:336-337), and an accepted peak requires ``params[2] <
gaussian_cutoff`` (base.py:334) — note the *signed* comparison, reproduced
here.

Design: a fixed-iteration scaled trust-region Levenberg-Marquardt
loop (lmdif's essential structure: column-norm parameter scaling D, trust
radius with gain-ratio updates, ftol/xtol convergence tests), batched over all
candidate windows at once via ``vmap``.  Masked points get zero residual
weight so edge-clamped (shorter) windows fit correctly inside a fixed-shape
buffer.  Non-convergence within the iteration budget maps to
``converged=False``, the analog of the RuntimeError path.

Decision-envelope contract: the f64
path agrees with ``scipy.optimize.curve_fit`` accept/reject on 119/120 mixed
probe windows; the f32 (production) path agrees 100% on realistic peak
windows in the suite and ~95-97% once pure-noise/degenerate windows are
included (719-window sweep: 687/720 at the default tolerances, 2
false-rejects).  The residual flips are windows scipy rejects by *exhausting
maxfev* — a property of its f64 iterate path that f32 arithmetic cannot
reproduce: a full-f64 fit on device replicates the verdicts but costs far
more; tightening ftol/xtol (3.45e-4 → 3e-7 sweep) and
perturbed-restart consensus both fail to separate the flip class.  The
envelope is pinned by tests/test_gaussfit.py::
test_f32_envelope_including_noise_windows and re-measured on the device by
every bench and smoke run (``utils/parity.gaussfit_agreement``).

The END-TO-END envelope: wild converged f32 fits (the scipy-maxfev flip
class — center far outside the window or amplitude far above the data)
are re-fit in f64 at MINPACK tolerances by the BPM
stage (pipeline/bpm.py ``f64_refine``; ``fd_jacobian`` here exists for that
characterization — the forward-difference variant measured strictly worse
than the analytic 500-iteration refit and does not ship).  ``bench.py
--bpm-corpus`` measures the whole-trajectory envelope against the
scipy-f64 chain.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


# All dots in the LM loop run at HIGHEST precision: a reduced default
# matmul precision (bf16, or TF32 on a GPU) perturbs the iterate path
# enough to flip accept/reject decisions vs the CPU/scipy oracle.  These
# are 3x3-scale products — the cost is nil.
_HI = jax.lax.Precision.HIGHEST

# Iteration budget for the safeguarded Newton solve of the trust-region
# lambda (see gaussian_fit_single).  Newton converges superlinearly once
# bracketed; 16 safeguarded steps reach f32 precision on the root from the
# [1e-12, 1e12] initial bracket (rejected-Newton steps fall back to the
# geometric midpoint, so the worst case is still a 16-level bisect).
_TR_NEWTON_ITERS = 16


class GaussFit(NamedTuple):
    ampl: jnp.ndarray
    center: jnp.ndarray
    dev: jnp.ndarray
    converged: jnp.ndarray   # bool — False is the RuntimeError-equivalent
    cost: jnp.ndarray


def _gauss(t, ampl, center, dev):
    return ampl * jnp.exp(-((t - center) ** 2) / (2.0 * dev ** 2))


def _solve3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 linear solve via the adjugate (no LAPACK custom call:
    vmappable).  Returns zeros for near-singular systems
    (treated as a null step by the trust-region loop)."""
    a00, a01, a02 = A[0, 0], A[0, 1], A[0, 2]
    a10, a11, a12 = A[1, 0], A[1, 1], A[1, 2]
    a20, a21, a22 = A[2, 0], A[2, 1], A[2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adjT = jnp.array([[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]])
    scale = jnp.max(jnp.abs(A)) + 1e-300
    ok = jnp.abs(det) > 1e-30 * scale ** 3
    x = jnp.dot(adjT, b, precision=_HI) / jnp.where(ok, det, 1.0)
    return jnp.where(ok, x, jnp.zeros_like(b))


def gaussian_fit_single(t: jnp.ndarray, y: jnp.ndarray, mask: jnp.ndarray,
                        iters: int = 200, ftol: float | None = None,
                        xtol: float | None = None,
                        fd_jacobian: bool = False) -> GaussFit:
    """Trust-region LM fit of a Gaussian to masked (t, y) points.

    Initial guess matches peakutils.gaussian_fit: ``[max(y), t[0], 5*dt]``
    where ``t[0]``/``dt`` refer to the first *valid* (masked-in) samples.

    Default tolerances are sqrt(machine-eps) of the input dtype (MINPACK's
    1.49e-8 for float64; ~3.5e-4 for the float32 path, below which f32
    roundoff makes the ftol/xtol tests unreachable).
    """
    dtype = y.dtype
    if ftol is None:
        ftol = 1.49e-8 if dtype == jnp.float64 else 3.45e-4
    if xtol is None:
        xtol = 1.49e-8 if dtype == jnp.float64 else 3.45e-4
    w = mask.astype(dtype)
    # Explicit int32 index math throughout: this fit is also traced INSIDE
    # a ``jax.enable_x64(True)`` region by the hybrid refinement
    # (pipeline/bpm.py) while the surrounding module is x64-off, and
    # default-dtype index ops (argmax -> i64) then fail MLIR verification
    # on this jaxlib (mixed-mode module type mismatch).
    nvalid = jnp.sum(mask, dtype=jnp.int32)

    npts = t.shape[0]
    idx32 = jax.lax.iota(jnp.int32, npts)
    first = jnp.min(jnp.where(mask, idx32, jnp.asarray(npts - 1, jnp.int32)))
    t0 = t[first]
    t1 = t[jnp.minimum(first + 1, npts - 1)]
    big_neg = jnp.asarray(-jnp.inf, dtype)
    ymax = jnp.max(jnp.where(mask, y, big_neg))
    p0 = jnp.stack([ymax, t0, (t1 - t0) * 5.0])

    def cost_and_resid(p):
        r = (_gauss(t, p[0], p[1], p[2]) - y) * w
        return jnp.sum(r * r), r

    def jacobian_analytic(p):
        ampl, center, dev = p[0], p[1], p[2]
        d = t - center
        e = jnp.exp(-(d ** 2) / (2.0 * dev ** 2))
        cols = jnp.stack(
            [e, ampl * e * d / (dev ** 2), ampl * e * (d ** 2) / (dev ** 3)],
            axis=-1)
        return cols * w[:, None]

    def jacobian_fd(p):
        # MINPACK fdjac2: forward differences with step eps = sqrt(machine
        # eps) * |p_j| (or eps itself when p_j == 0).  lmdif's iterate path
        # on degenerate windows depends on this noisy jacobian; the hybrid
        # refinement (pipeline/bpm.py) uses it so "converged within budget"
        # tracks scipy's verdict rather than the analytic-jacobian path's.
        sq = jnp.sqrt(jnp.asarray(
            1.19e-7 if dtype == jnp.float32 else 2.22e-16, dtype))
        base = _gauss(t, p[0], p[1], p[2])
        cols = []
        for j in range(3):
            h = sq * jnp.abs(p[j])
            h = jnp.where(h == 0, sq, h)
            pj = p.at[j].add(h)
            cols.append((_gauss(t, pj[0], pj[1], pj[2]) - base) / h)
        return jnp.stack(cols, axis=-1) * w[:, None]

    jacobian = jacobian_fd if fd_jacobian else jacobian_analytic

    F0, _ = cost_and_resid(p0)
    J0 = jacobian(p0)
    D0 = jnp.sqrt(jnp.sum(J0 * J0, axis=0))
    D0 = jnp.where(D0 == 0, 1.0, D0)
    Delta0 = 100.0 * jnp.sqrt(jnp.sum((D0 * p0) ** 2))
    Delta0 = jnp.where(Delta0 == 0, 100.0, Delta0)

    def cond(carry):
        it, p, F, D, Delta, done = carry
        return (it < iters) & ~done

    def step(carry):
        it, p, F, D, Delta, done = carry
        _, r = cost_and_resid(p)
        J = jacobian(p)
        D = jnp.maximum(D, jnp.sqrt(jnp.sum(J * J, axis=0)))
        JtJ = jnp.matmul(J.T, J, precision=_HI)
        g = jnp.dot(J.T, r, precision=_HI)
        reg = 1e-10 * jnp.trace(JtJ) * jnp.eye(3, dtype=dtype)

        def solve(lam):
            return _solve3(JtJ + lam * jnp.diag(D * D) + reg, -g)

        d_gn = solve(jnp.asarray(0.0, dtype))
        gn_norm = jnp.sqrt(jnp.sum((D * d_gn) ** 2))
        inside = gn_norm <= Delta

        # Solve ||D d(lam)|| = Delta for the LM parameter by safeguarded
        # Newton on 1/||D d|| (More-Sorensen; MINPACK lmpar's update rule),
        # maintaining a geometric bracket: a rejected Newton candidate
        # falls back to sqrt(lo*hi), so the worst case degrades to the old
        # geometric bisect.  This finds the root of the SAME scalar
        # equation the previous 3-stage 2^8+1-point grid bisect resolved
        # to ~3e-6 relative (Newton reaches f32 precision), so the visited
        # LM iterates agree to the same rounding class as that grid — do
        # not rely on bit-reproducibility across solver revisions; the
        # accept/reject contract is validated against the scipy oracle
        # (tests/test_gaussfit.py) and spot-checked on device (bench
        # warmup).  Cost per LM iteration drops from 771 batched 3x3
        # solves (the grids) to at most 2*_TR_NEWTON_ITERS + 2 — the
        # gaussian-fit stage was compute-bound on those grids (measured
        # 2.4 ms/LM-iteration at 4096 vmapped lanes, round 4).
        #
        # Derivation: with A(lam) = JtJ + lam*diag(D^2) + reg,
        # d(lam) = A^-1 (-g), n(lam) = ||D d||, the Newton step on
        # psi(lam) = 1/n - 1/Delta is
        #   lam+ = lam + (n - Delta)/Delta * n^2 / (q . A^-1 q),
        # where q = diag(D^2) d  (so n' = -(q . A^-1 q)/n).
        def tr_newton(lam, lo, hi):
            d = solve(lam)
            dn = jnp.sqrt(jnp.sum((D * d) ** 2))
            q = (D * D) * d
            v = _solve3(JtJ + lam * jnp.diag(D * D) + reg, q)
            qv = jnp.dot(q, v, precision=_HI)
            root_above = dn > Delta          # ||D d|| too big -> raise lam
            lo = jnp.where(root_above, lam, lo)
            hi = jnp.where(root_above, hi, lam)
            cand = lam + (dn - Delta) * dn * dn / (Delta * qv)
            ok = jnp.isfinite(cand) & (cand > lo) & (cand < hi) & (qv > 0)
            return jnp.where(ok, cand, jnp.sqrt(lo * hi)), lo, hi

        lo = jnp.asarray(1e-12, dtype)
        hi = jnp.asarray(1e12, dtype)
        par = jnp.sqrt(lo * hi)
        for _ in range(_TR_NEWTON_ITERS):
            par, lo, hi = tr_newton(par, lo, hi)
        delta = jnp.where(inside, d_gn, solve(par))

        p_new = p + delta
        F_new, _ = cost_and_resid(p_new)
        pred = -(2.0 * jnp.dot(g, delta, precision=_HI)
                 + jnp.dot(delta, jnp.dot(JtJ, delta, precision=_HI),
                           precision=_HI))
        actred = F - F_new
        ratio = jnp.where(pred > 0, actred / jnp.where(pred > 0, pred, 1.0),
                          0.0)
        pnorm = jnp.sqrt(jnp.sum((D * delta) ** 2))

        # Trust-region update per MINPACK lmdif: on a poor step the radius
        # shrinks to temp * min(Delta, 10*pnorm) — bounded by the STEP size,
        # not the (possibly huge initial) radius.  Halving the stale radius
        # instead lets an early wild step (e.g. the first Gauss-Newton step
        # zeroing the amplitude) fling the iterate into a flat DC-offset
        # basin that MINPACK never visits.
        dirder = jnp.dot(g, delta, precision=_HI)  # <= 0 for LM/GN steps
        temp = jnp.where(actred >= 0, 0.5,
                         0.5 * dirder / (dirder + 0.5 * actred))
        temp = jnp.where(F_new >= 100.0 * F, 0.1, temp)
        temp = jnp.where(jnp.isfinite(temp), temp, 0.1)
        temp = jnp.clip(temp, 0.1, 0.5)
        Delta_new = jnp.where(ratio <= 0.25,
                              temp * jnp.minimum(Delta, 10.0 * pnorm),
                              jnp.where((ratio >= 0.75) | inside,
                                        2.0 * pnorm, Delta))
        accept = (ratio > 1e-4) & jnp.all(jnp.isfinite(p_new)) \
            & jnp.isfinite(F_new)

        ftol_hit = accept & (jnp.abs(actred) <= ftol * F) \
            & (pred <= ftol * F) & (ratio <= 2.0)
        p_acc = jnp.where(accept, p_new, p)
        F_acc = jnp.where(accept, F_new, F)
        xtol_hit = Delta_new <= xtol * jnp.sqrt(jnp.sum((D * p_acc) ** 2))
        done_new = done | ftol_hit | xtol_hit
        return (it + 1, p_acc, F_acc, D, Delta_new, done_new)

    # Lanes that can never produce a converged fit start DONE: fully-masked
    # or under-determined windows (nvalid < 3 — the curve_fit TypeError
    # analog) and non-finite initial cost (empty windows: ymax = -inf).
    # Contract: params/cost of NON-CONVERGED lanes are unspecified (for
    # done-at-init lanes they are (p0, F0); 1-2-point windows running the
    # loop would instead return regularized-LM-accepted steps) — callers
    # must gate every output on ``converged``, as pipeline/bpm.py does;
    # ``converged`` itself stays False here via the nvalid >= 3 gate.
    # Done-at-init matters because under vmap the while_loop runs to the
    # SLOWEST lane, and a fleet batch is mostly empty candidate slots
    # (streams x max_peaks lanes, few real candidates): without this,
    # every fleet step paid the full 200-iteration budget on behalf of
    # its empty slots (measured 215 ms of a 253 ms 64x1080p step).
    # The ~isfinite(F0) arm assumes a non-degenerate window's f32 initial
    # cost is finite (true at filtered-signal magnitudes — overflow needs
    # residuals ~1e19); a lane tripping it is permanently converged=False
    # even if its gradient were finite, foreclosing a recovery path that
    # is unreachable in practice.
    done0 = (nvalid < 3) | ~jnp.isfinite(F0)
    init = (jnp.asarray(0, jnp.int32), p0, F0, D0, Delta0, done0)
    # while_loop (not a fixed scan) so a vmapped batch stops as soon as all
    # lanes converge — the common case is <40 iterations, not the full
    # budget, which matters inside the whole-clip scan fast path.
    _, p, F, _, _, done = jax.lax.while_loop(cond, step, init)

    finite = jnp.all(jnp.isfinite(p)) & jnp.isfinite(F)
    enough = nvalid >= 3  # need >= #params points, else curve_fit raises
    converged = done & finite & enough
    return GaussFit(ampl=p[0], center=p[1], dev=p[2],
                    converged=converged, cost=F)


@partial(jax.jit, static_argnames=("iters", "fd_jacobian"))
def gaussian_fit_batch(t: jnp.ndarray, y: jnp.ndarray, mask: jnp.ndarray,
                       iters: int = 200,
                       fd_jacobian: bool = False) -> GaussFit:
    """vmapped trust-region LM Gaussian fit over a batch of masked windows.

    Shapes: t, y, mask are (B, W); returns GaussFit of (B,) arrays.
    """
    return jax.vmap(lambda ti, yi, mi: gaussian_fit_single(
        ti, yi, mi, iters=iters, fd_jacobian=fd_jacobian))(t, y, mask)
