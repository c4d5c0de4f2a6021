"""The spectral PDE solver family (the reference's ``apps/pde.py``): ONE
spectral pipeline — forward FFT every axis through the plan layer,
apply a REAL spectral multiplier, invert — parameterized by the
multiplier, so Poisson (``parallel/poisson3d.py`` is a thin shim over
this module), constant- and variable-coefficient Helmholtz and an exact
spectral time-stepper are one code path.

All spectral arithmetic stays on split re/im float32 planes: every
multiplier is real, so the planes never recombine.  Kernel dispatch is
per axis shape: each axis pass fetches the plan for its own shape's key.
An axis pass moves its axis to the end with an explicit contiguous copy
(``fft_axis``; counted in :data:`AXIS_COPIES`), since the plans'
kernels take contiguous planes.

The sharded 3-D slab pipeline (:func:`solve_spectral_sharded`) holds
this rank's slab and makes two ``all_to_all`` transposes through
``parallel.collectives``; the collective-free escape
(``parallel/escape.py``) replays the same per-block pipeline with the
same block multipliers (:func:`block_multiplier`), so primary and escape
are bit-identical.

Multipliers are ``symbol(ksq) -> multiplier`` callables over the squared
wavenumber grid:

    poisson:    -1/|k|^2, zero mode -> 0 (the mean-free solution)
    helmholtz:  1/(alpha + |k|^2)   for (alpha - lap) u = f
    heat step:  exp(-nu |k|^2 t)    (the exact integrator of
                                     u_t = nu lap u)

Variable-coefficient Helmholtz has no diagonal symbol; it is solved by
the fixed-point split alpha = mean + fluctuation, each iteration one
constant-coefficient spectral solve.

Each whole-grid solve runs under a ``spectral_solve`` span, counts on
``pifft_apps_ops_total{op="solve"}`` and charges its traffic on the
roofline's bytes meter (``utils.roofline.charge_spectral_traffic("solve",
prod(shape))``); a variable-coefficient solve that does not converge
counts on ``pifft_apps_solve_nonconverged_total`` (all no-ops while
observability is disarmed).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from .. import plans
from ..obs import metrics
from ..obs.spans import span
from ..utils.device import as_plane
from ..utils.roofline import charge_spectral_traffic

#: explicit contiguous copies made by ``fft_axis`` (an axis moved to the
#: end of strided planes): PyTorch copy launches beside each plan call
AXIS_COPIES = 0

def wavenumbers(m: int) -> np.ndarray:
    """Integer wavenumbers for an m-point periodic axis (fftfreq * m)."""
    k = np.arange(m)
    k[k > m // 2] -= m
    return k.astype(np.float32)


@lru_cache(maxsize=64)
def _wavenumbers_on(m: int, device: torch.device):
    """``wavenumbers(m)`` on `device`, cached: a solve moves no table to
    the card after its first call, so its calls can be captured."""
    return torch.from_numpy(wavenumbers(m)).to(device)


@lru_cache(maxsize=16)
def _ksq_on(shape: tuple, device: torch.device):
    """``_ksq_grid(shape)`` on `device`, cached."""
    return torch.from_numpy(_ksq_grid(shape)).to(device)


def _last_axis(v, ax: int):
    """`v` with axis `ax` moved to the end, contiguous: a copy (counted)
    unless the move leaves it contiguous already."""
    global AXIS_COPIES
    v = v.movedim(ax, -1)
    if not v.is_contiguous():
        AXIS_COPIES += 1
        v = v.contiguous()
    return v


def fft_axis(vr, vi, ax: int, inverse: bool):
    """One planned FFT pass over axis `ax` of split planes: move the
    axis to the end (an explicit contiguous copy), fetch the plan for
    THIS shape's key, execute, move back (a view)."""
    vr, vi = _last_axis(vr, ax), _last_axis(vi, ax)
    plan = plans.plan_for(vr.shape, device=vr.device)
    if inverse:
        yr, yi = plan.execute_inverse(vr, vi)
    else:
        yr, yi = plan.execute(vr, vi)
    return yr.movedim(-1, ax), yi.movedim(-1, ax)


# ------------------------------------------------------- multipliers


def poisson_multiplier(ksq):
    """-1/|k|^2 with the zero mode -> 0: the mean-free solution of
    lap(u) = f."""
    return torch.where(ksq > 0, -1.0 / torch.clamp(ksq, min=1e-30),
                       torch.zeros((), dtype=ksq.dtype, device=ksq.device))


def helmholtz_multiplier(alpha: float) -> Callable:
    """1/(alpha + |k|^2): the symbol of (alpha - lap) u = f, alpha > 0
    (at alpha = 0 the zero mode is singular: use Poisson)."""
    if alpha <= 0:
        raise ValueError(f"helmholtz alpha={alpha} must be > 0 "
                         f"(alpha=0 is the Poisson problem)")
    a = float(np.float32(alpha))

    def mult(ksq):
        return 1.0 / (a + ksq)

    return mult


def heat_multiplier(nu: float, t: float) -> Callable:
    """exp(-nu |k|^2 t): the exact solution operator of the periodic
    heat equation u_t = nu lap(u) over time t."""
    nu32, t32 = float(np.float32(nu)), float(np.float32(t))

    def mult(ksq):
        return torch.exp(-nu32 * ksq * t32)

    return mult


def _ksq_grid(shape: tuple) -> np.ndarray:
    """|k|^2 over the full grid (host-built float32)."""
    ksq = np.zeros(shape, np.float32)
    for ax, m in enumerate(shape):
        k = wavenumbers(m).astype(np.float64) ** 2
        expand = [1] * len(shape)
        expand[ax] = m
        ksq = ksq + k.reshape(expand).astype(np.float32)
    return ksq


# -------------------------------------------------- full-grid solves


def solve_spectral(f, multiplier: Callable, device=None):
    """The single-device pipeline: real field `f` (any ndim, every axis a
    power of two; numpy goes to `device`, the card by default) ->
    forward FFT every axis through the plan layer, multiply by the REAL
    ``multiplier(ksq)``, invert every axis.  Returns the real solution
    (the imaginary plane of a real-input, real-symbol pipeline is
    roundoff and dropped)."""
    f = as_plane(f, device)
    shape = tuple(int(s) for s in f.shape)
    gr, gi = f, torch.zeros_like(f)
    with span("spectral_solve", cell={"op": "solve",
                                      "n": int(np.prod(shape))}):
        for ax in range(len(shape)):
            gr, gi = fft_axis(gr, gi, ax, False)
        m = multiplier(_ksq_on(shape, f.device))
        gr, gi = gr * m, gi * m
        for ax in range(len(shape)):
            gr, gi = fft_axis(gr, gi, ax, True)
        metrics.inc("pifft_apps_ops_total", op="solve")
        charge_spectral_traffic("solve", int(np.prod(shape)))
    return gr.contiguous()


def poisson_solve(f, device=None):
    """lap(u) = f on the periodic grid, zero-mean, any ndim."""
    return solve_spectral(f, poisson_multiplier, device)


def helmholtz_solve(f, alpha: float, device=None):
    """(alpha - lap) u = f on the periodic grid, alpha > 0."""
    return solve_spectral(f, helmholtz_multiplier(alpha), device)


def helmholtz_solve_variable(f, alpha_field, iters: int = 40,
                             tol: float = 1e-6, device=None):
    """(alpha(x) - lap) u = f with a VARIABLE coefficient: split alpha =
    mean + fluctuation and iterate

        u_{j+1} = S_mean( f - (alpha - mean) u_j )

    each S_mean one constant-coefficient spectral solve — convergent
    while the fluctuation stays under the mean.  A non-converged exit
    warns rather than lying.  Returns the solution field."""
    f = as_plane(f, device)
    alpha_field = as_plane(alpha_field, f.device)
    if alpha_field.shape != f.shape:
        raise ValueError(f"alpha field shape {tuple(alpha_field.shape)} "
                         f"!= rhs shape {tuple(f.shape)}")
    abar = float(alpha_field.mean())
    if abar <= 0:
        raise ValueError(f"mean(alpha)={abar} must be > 0")
    fluct = alpha_field - float(np.float32(abar))
    mult = helmholtz_multiplier(abar)
    u = solve_spectral(f, mult)
    err = np.inf
    for _ in range(iters):
        u_next = solve_spectral(f - fluct * u, mult)
        err = float((u_next - u).abs().max()
                    / torch.clamp(u_next.abs().max(), min=1e-30))
        u = u_next
        if err <= tol:
            break
    if err > tol:
        metrics.inc("pifft_apps_solve_nonconverged_total")
        plans.warn(f"variable-coefficient helmholtz did not converge "
                   f"in {iters} iteration(s) (rel step {err:.2e} > "
                   f"{tol:.0e}); returning the best iterate — treat "
                   f"as degraded")
    return u


def spectral_step(u0, nu: float, dt: float, steps: int = 1, device=None):
    """March the periodic heat equation u_t = nu lap(u) by `steps` steps
    of `dt` with the exact spectral integrator (one pipeline, the
    one-step symbol raised to the step count)."""
    if steps < 1:
        raise ValueError(f"steps={steps} must be >= 1")
    return solve_spectral(u0, heat_multiplier(nu, dt * steps), device)


# ------------------------------------------------- sharded 3-D slabs


def block_multiplier(multiplier: Callable, n1: int, n2: int, n3: int,
                     j: int, p: int, device):
    """``multiplier(ksq)`` on the (n1, n2/p, n3) block j of the grid (the
    n2 columns j*n2/p .. (j+1)*n2/p): the primary path's multiplier on
    rank j and the escape's on its block j, the same values."""
    device = torch.device(device)
    k1, k2, k3 = (_wavenumbers_on(m, device) for m in (n1, n2, n3))
    s2 = n2 // p
    k2_loc = k2[j * s2:(j + 1) * s2]
    ksq = (k1[:, None, None] ** 2 + k2_loc[None, :, None] ** 2
           + k3[None, None, :] ** 2)
    return multiplier(ksq)


def slab_forward(f):
    """Phase 1 of the slab pipeline: a real (n1/p, n2, n3) slab -> its
    FFT over axes 2 and 1, split planes."""
    gr, gi = fft_axis(f, torch.zeros_like(f), 2, False)
    return fft_axis(gr, gi, 1, False)


def column_solve(gr, gi, m):
    """Phase 2: an (n1, n2/p, n3) column block -> its axis-0 FFT times
    the block's REAL multiplier `m`, transformed back over axis 0."""
    gr, gi = fft_axis(gr, gi, 0, False)
    return fft_axis(gr * m, gi * m, 0, True)


def slab_inverse(gr, gi):
    """Phase 3: an (n1/p, n2, n3) slab -> its inverse over axes 1 and 2,
    the real plane, contiguous."""
    gr, gi = fft_axis(gr, gi, 1, True)
    gr, _ = fft_axis(gr, gi, 2, True)
    return gr.contiguous()


def solve_spectral_sharded(f, mesh, axis: str = "p",
                           multiplier: Callable = poisson_multiplier):
    """The slab-decomposed 3-D pipeline (BASELINE config 5): `f` this
    rank's real (n1/p, n2, n3) slab; phase 1 (:func:`slab_forward`),
    one all_to_all transpose to localize axis 0 — (n1/p, n2, n3) ->
    (n1, n2/p, n3) — phase 2 (:func:`column_solve`) with the REAL
    `multiplier` on the rank's block, the transpose back, phase 3
    (:func:`slab_inverse`).  The escape runs the same phases over every
    block.  Two transposes of two planes each: four collectives a
    solve.  Returns the rank's real (n1/p, n2, n3) slab of u."""
    from ..parallel.collectives import all_to_all

    f = as_plane(f, mesh.device)
    p = mesh.shape[axis]
    s1, n2, n3 = f.shape

    def a2a(v, split_axis, concat_axis):
        return all_to_all(v, axis, split_axis, concat_axis, mesh=mesh)

    gr, gi = slab_forward(f)
    m = block_multiplier(multiplier, s1 * p, n2, n3, mesh.axis_index(axis),
                         p, f.device)
    gr, gi = column_solve(a2a(gr, 1, 0), a2a(gi, 1, 0), m)
    return slab_inverse(a2a(gr, 0, 1), a2a(gi, 0, 1))


def helmholtz_solve_sharded(f, mesh, axis: str = "p", alpha: float = 1.0):
    """(alpha - lap) u = f on the sharded slab pipeline."""
    return solve_spectral_sharded(f, mesh, axis,
                                  helmholtz_multiplier(alpha))


def spectral_step_sharded(u0, mesh, axis: str = "p", nu: float = 1.0,
                          dt: float = 1e-3, steps: int = 1):
    """The exact heat step on the sharded slab pipeline."""
    if steps < 1:
        raise ValueError(f"steps={steps} must be >= 1")
    return solve_spectral_sharded(u0, mesh, axis,
                                  heat_multiplier(nu, dt * steps))
