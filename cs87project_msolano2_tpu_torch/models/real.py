"""Half-spectrum real-input transforms: rfft / irfft on the plan ladder
(the reference's ``models/real.py``).

A length-n real signal's spectrum is Hermitian (X[n-k] = conj(X[k])),
so only the n//2+1 leading bins are computed.  The pack trick turns the
r2c transform into ONE c2c transform at half the length plus an O(n)
elementwise pass:

    z[k]  = x[2k] + i x[2k+1]             (m = n/2 complex points)
    Z     = FFT_m(z)                       (the c2c plan at n/2)
    A[k]  = (Z[k] + conj(Z[m-k])) / 2      (spectrum of the even samples)
    B[k]  = (Z[k] - conj(Z[m-k])) / 2i     (spectrum of the odd samples)
    X[k]  = A[k] + W^k B[k],  W = e^{-2 pi i/n},  k = 0..m

The inverse (c2r) runs the same algebra backwards: split X into (A, B),
Z = A + i B, one c2c inverse at m, interleave.

The passes are elementwise torch operations on split float32 planes
around the c2c plan at n/2, as the reference's are ``jnp`` outside any
kernel: an even-n r2c transform runs whatever kernels the ladder serves
the c2c key at n/2.  Odd n has no pack split and takes the direct
any-length path (``ops.anylen``).  Dispatch goes through ``domain="r2c"``
/ ``"c2r"`` plan keys; the r2c executor keeps the ``(xr, xi) -> (yr,
yi)`` contract with ``xi`` ignored (the input is real by declaration),
and the c2r output's ``yi`` is zeros.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..obs.spans import call_span, path_span
from ..utils.device import as_plane, as_planes
from .fft import _complex_planes


def half_twiddles_host(n: int) -> tuple:
    """(cos, sin) of 2 pi k/n for k = 0..n/2 in float64: the W^k factors
    of the Hermitian merge and split, before the one cast to float32."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / float(n)
    return np.cos(ang), np.sin(ang)


@lru_cache(maxsize=32)
def _half_twiddles(n: int, device: torch.device) -> tuple:
    """``half_twiddles_host(n)`` cast once to float32 tensors on
    `device`."""
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in half_twiddles_host(n))


def pack_real_planes(xr):
    """Deinterleave a real signal (..., n) into the packed complex planes
    (..., n/2), contiguous: z[k] = x[2k] + i x[2k+1]."""
    return xr[..., 0::2].contiguous(), xr[..., 1::2].contiguous()


def unpack_real_planes(zr, zi):
    """Inverse of :func:`pack_real_planes`: interleave (..., m) planes
    back into the real signal (..., 2m)."""
    return torch.stack([zr, zi], dim=-1).reshape(
        zr.shape[:-1] + (2 * zr.shape[-1],))


def hermitian_merge(zr, zi, n: int):
    """The O(n) r2c post-pass: packed-FFT planes (..., m) in natural
    order -> half-spectrum planes (..., m+1), m = n/2.  Z[k] for k =
    0..m is Z with Z[0] appended (Z[m] = Z[0]), and Z[(m-k) mod m] is
    that extension flipped."""
    zr_k = torch.cat([zr, zr[..., :1]], -1)
    zi_k = torch.cat([zi, zi[..., :1]], -1)
    zr_r, zi_r = zr_k.flip(-1), zi_k.flip(-1)
    ar, ai = 0.5 * (zr_k + zr_r), 0.5 * (zi_k - zi_r)
    br, bi = 0.5 * (zi_k + zi_r), -0.5 * (zr_k - zr_r)
    c, s = _half_twiddles(n, zr.device)
    return ar + c * br + s * bi, ai + c * bi - s * br


def hermitian_split(xr, xi, n: int):
    """The O(n) c2r pre-pass: half-spectrum planes (..., m+1) -> packed
    planes Z = A + i B of length m, ready for one c2c inverse.  X[m-k]
    for k = 0..m-1 is X[1..m] flipped."""
    m = n // 2
    xr_k, xi_k = xr[..., :m], xi[..., :m]
    xr_r, xi_r = xr[..., 1:m + 1].flip(-1), xi[..., 1:m + 1].flip(-1)
    ar, ai = 0.5 * (xr_k + xr_r), 0.5 * (xi_k - xi_r)
    # W^k B[k] = (X[k] - conj(X[m-k])) / 2; undo the twiddle with W^-k
    tr, ti = 0.5 * (xr_k - xr_r), 0.5 * (xi_k + xi_r)
    c, s = _half_twiddles(n, xr.device)
    c, s = c[:m], s[:m]
    br, bi = c * tr - s * ti, c * ti + s * tr
    return ar - bi, ai + br


def rfft_executor(c2c_fn, n: int):
    """Wrap a natural-order c2c executor at n/2 into the r2c executor at
    n: (xr, xi) -> half-spectrum planes (..., n/2+1), ``xi`` ignored."""

    def run(xr, xi):
        del xi  # real by declaration (domain="r2c")
        with path_span("real.pack"):
            zr, zi = pack_real_planes(xr)
        zr, zi = c2c_fn(zr, zi)
        with path_span("real.merge"):
            return hermitian_merge(zr, zi, n)

    return run


def irfft_executor(c2c_fn, n: int):
    """Wrap a natural-order c2c executor at n/2 into the c2r executor at
    n: half-spectrum planes (..., n/2+1) -> (real signal, zeros).  The
    inverse c2c is the conj trick on the same forward executor, so the
    variant serving the forward serves the inverse too."""
    inv_m = 1.0 / (n // 2)

    def run(xr, xi):
        zr, zi = hermitian_split(xr, xi, n)
        wr, wi = c2c_fn(zr, -zi)          # IFFT_m = conj FFT_m conj / m
        yr = unpack_real_planes(wr * inv_m, -wi * inv_m)
        return yr, torch.zeros_like(yr)

    return run


def real_executor(c2c_fn, domain: str, n: int):
    """The r2c or c2r executor at n (`domain`) around the natural-order
    c2c executor at n/2."""
    if domain == "r2c":
        return rfft_executor(c2c_fn, n)
    return irfft_executor(c2c_fn, n)


def _real_plane(x, device):
    """A float32 plane of real numpy or tensor input, on `device` (the
    card by default; a tensor stays where it lies unless `device` names
    another).  Complex input is refused, as the reference's."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.is_complex() if isinstance(x, torch.Tensor) \
            else np.iscomplexobj(x):
        raise ValueError("rfft input must be real (the half-spectrum "
                         "contract); use fft for complex input")
    return as_plane(x, device)


def rfft(x, precision: str | None = None, plan=None, device=None):
    """1-D real-input DFT over the trailing axis: real in, the n//2+1
    leading complex bins out (``numpy.fft.rfft`` semantics) through a
    ``domain="r2c"`` plan.  Any n >= 2: even n rides the c2c plan at n/2,
    odd n a direct any-length plan.  `plan` pins an explicit r2c plan;
    `precision` picks the mode as in ``models.fft.fft``.  Numpy input
    goes to `device` (the card by default)."""
    with call_span("fft.call"):
        with path_span("fft.split"):
            xr = _real_plane(x, device)
        yr, yi = rfft_planes_fast(xr, plan=plan, precision=precision)
        with path_span("fft.join"):
            return torch.complex(yr, yi)


def irfft(x, precision: str | None = None, plan=None, device=None):
    """Inverse of :func:`rfft`: n//2+1 half-spectrum bins in, the length
    n real signal out (``numpy.fft.irfft`` semantics; n = 2 (bins - 1),
    even: pass `n` to :func:`irfft_planes_fast`, or pin a c2r `plan`,
    for an odd length)."""
    xr, xi = _complex_planes(x, device)
    if xr.shape[-1] < 2:
        raise ValueError(f"irfft needs >= 2 half-spectrum bins, got shape "
                         f"{tuple(xr.shape)}")
    return irfft_planes_fast(xr, xi, plan=plan, precision=precision)


def rfft_planes_fast(xr, plan=None, precision: str | None = None,
                     device=None):
    """Plane-level r2c through the plan layer: real plane(s) in,
    half-spectrum (yr, yi) planes out."""
    xr = as_plane(xr, device)
    if plan is None:
        from .. import plans

        plan = plans.plan_for(xr.shape, layout="natural",
                              precision=precision, domain="r2c",
                              device=xr.device)
    # the r2c executor ignores its imaginary plane: xr stands in for it
    return plan.execute(xr, xr)


def irfft_planes_fast(xr, xi, n: int | None = None, plan=None,
                      precision: str | None = None, device=None):
    """Plane-level c2r: half-spectrum planes (..., m+1) in, the real
    signal plane (..., n) out (n defaults to 2 m)."""
    xr, xi = as_planes(xr, xi, device)
    n = n if n is not None else 2 * (xr.shape[-1] - 1)
    if plan is None:
        from .. import plans

        plan = plans.plan_for(xr.shape[:-1] + (n,), layout="natural",
                              precision=precision, domain="c2r",
                              device=xr.device)
    yr, _ = plan.execute(xr, xi)
    return yr
