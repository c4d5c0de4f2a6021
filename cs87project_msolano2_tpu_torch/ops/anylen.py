"""Any-length transforms on the plan ladder: Bluestein, Rader and mixed
radix as plan variants (the reference's ``ops/anylen.py``).

The kernel family speaks powers of two; these three variants serve any
n >= 2 with no kernel of their own, each around power-of-two c2c
subplans that run the Hopper kernels:

* ``bluestein`` — the chirp-z identity.  With ``b[t] = exp(-i pi t^2/n)``
  the transform is ``X[k] = b[k] sum_j (x[j] b[j]) conj(b[k-j])``: one
  circular convolution at a padded length ``pad >= 2n-1`` (one forward
  and one inverse c2c at the pad, the inverse by the conj trick on the
  same subplan), chirp multiplies before and after.
* ``rader`` — prime n: the n-1 outputs past the DC bin are a length
  n-1 cyclic convolution of the input permuted by a primitive root g,
  on the same padded machinery.
* ``mixedradix`` — n = m * 2^a with odd m: reshape to (m, 2^a), the odd
  axis's DFT as one m x m matrix product (``torch.matmul``, as the
  reference's ``einsum``), twiddle, then ONE batched power-of-two
  subplan over the 2^a axis.

The pads (:func:`pad_candidates`) are the smallest feasible lengths
>= 2n-1: the next power of two, and 3 * 2^j or 5 * 2^j where smaller;
a mixed pad's own subplan is a one-level ``mixedradix`` split, so the
recursion stops there.

The tables (chirp, Rader's permutations and kernel spectrum, the
mixed-radix DFT matrix and twiddles) are built on the host in float64,
the kernel spectra by a host numpy FFT, and cast to float32 once; never
on the transform's path.  They are cached per (variant, n, pad,
precision, device) with a hit/miss count (``CHIRP_CACHE_STATS``), so
tables built for one device are never handed to a call on another.
The executors work on split float32 planes over the trailing axis,
batched over the leading ones, and run where their planes lie.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

#: the largest odd factor the mixedradix m x m DFT matrix takes; above
#: it the O(m^2) product loses to a Bluestein pad
MIXEDRADIX_MAX_ODD = 512

#: primes above this take Rader's cyclic convolution; smaller primes are
#: cheaper as a bare mixedradix DFT matrix (m = n, a = 0)
RADER_MIN_N = 64

ANYLEN_VARIANTS = ("bluestein", "rader", "mixedradix")


def is_pow2(n: int) -> bool:
    return n >= 1 and not (n & (n - 1))


def next_pow2(v: int) -> int:
    n = 2
    while n < v:
        n *= 2
    return n


def odd_split(n: int) -> tuple:
    """(a, m) with n = m * 2^a and m odd."""
    a = 0
    while n % 2 == 0:
        n //= 2
        a += 1
    return a, n


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def primitive_root(p: int) -> int:
    """Smallest primitive root of an odd prime p (trial over the prime
    factors of p-1)."""
    factors = set()
    m = p - 1
    f = 2
    while f * f <= m:
        while m % f == 0:
            factors.add(f)
            m //= f
        f += 1
    if m > 1:
        factors.add(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no primitive root for p={p} (not an odd prime?)")


def pad_candidates(n: int) -> list:
    """The padded convolution lengths raced for an n-point chirp (or an
    n-point cyclic Rader convolution): each >= 2n-1, even, and a power
    of two or a 3 * 2^j / 5 * 2^j size whose subplan is a one-level
    mixedradix split.  Cheapest first, at most three, and the next
    power of two always among them."""
    lo = max(2 * n - 1, 2)
    p2 = next_pow2(lo)
    cands = {p2}
    for odd in (3, 5):
        m = odd * 2
        while m < lo:
            m *= 2
        if m < p2:
            cands.add(m)
    return sorted(cands)


def default_pad(n: int) -> int:
    """The static pad: the cheapest feasible candidate."""
    return pad_candidates(n)[0]


def plan_variant(n: int) -> str:
    """The static any-length variant for a non-power-of-two n: ``rader``
    for primes above RADER_MIN_N, ``mixedradix`` while the odd factor
    stays under MIXEDRADIX_MAX_ODD, ``bluestein`` otherwise."""
    if is_pow2(n):
        raise ValueError(f"n={n} is a power of two — the kernel ladder "
                         f"serves it directly")
    if n > RADER_MIN_N and is_prime(n):
        return "rader"
    _, m = odd_split(n)
    if m <= MIXEDRADIX_MAX_ODD:
        return "mixedradix"
    return "bluestein"


# --- the table cache ------------------------------------------------------

_CHIRP_LOCK = threading.Lock()
_CHIRP_CACHE: dict = {}

#: the most cached table sets; past it the least recently used goes
CHIRP_CACHE_MAX = 64

#: lookups of the table cache by result, read by the tests (the
#: reference counts them in its metrics as
#: ``pifft_anylen_chirp_cache_total{result=...}``)
CHIRP_CACHE_STATS = {"hit": 0, "miss": 0}


def _cached_tables(key: tuple, build: Callable) -> tuple:
    with _CHIRP_LOCK:
        hit = _CHIRP_CACHE.pop(key, None)
        if hit is not None:
            _CHIRP_CACHE[key] = hit  # re-append: LRU recency
        CHIRP_CACHE_STATS["hit" if hit is not None else "miss"] += 1
    if hit is not None:
        return hit
    val = build()
    with _CHIRP_LOCK:
        _CHIRP_CACHE[key] = val
        while len(_CHIRP_CACHE) > CHIRP_CACHE_MAX:
            _CHIRP_CACHE.pop(next(iter(_CHIRP_CACHE)))
    return val


def chirp_cache_clear() -> None:
    """Drop the cached tables (tests, memory pressure)."""
    with _CHIRP_LOCK:
        _CHIRP_CACHE.clear()


def _circ_kernel_spectrum(lags: np.ndarray, pad: int) -> np.ndarray:
    """FFT (float64, host) of a convolution kernel embedded circularly at
    `pad`.  `lags` has length 2L-1, laid out [lag 0..L-1, then lag
    -(L-1)..-1]: the positive lags land at h[0:L], the negative lag -t
    wraps to h[pad-t].  pad >= 2L-1 keeps the halves apart, so a linear
    convolution at `pad` gives the length-L circular one on its first L
    outputs."""
    L = (lags.shape[0] + 1) // 2
    h = np.zeros(pad, np.complex128)
    h[:L] = lags[:L]
    if L > 1:
        h[pad - (L - 1):] = lags[L:]
    return np.fft.fft(h)


def bluestein_host_tables(n: int, pad: int) -> tuple:
    """(br, bi, Hr, Hi) float32 arrays for an n-point chirp transform at
    pad >= 2n-1: the chirp ``exp(-i pi t^2/n)`` (float64 trig on
    ``t^2 mod 2n``, so the angle keeps its bits at large n) and the
    padded spectrum of its conjugate kernel."""
    if pad < 2 * n - 1:
        raise ValueError(f"bluestein pad {pad} < 2n-1 = {2 * n - 1}")
    t = np.arange(n, dtype=np.int64)
    ang = np.pi * ((t * t) % (2 * n)).astype(np.float64) / float(n)
    b = np.cos(ang) - 1j * np.sin(ang)
    h = np.conj(b)
    full = np.concatenate([h, h[1:][::-1]])
    H = _circ_kernel_spectrum(full, pad)
    return (b.real.astype(np.float32), (-np.sin(ang)).astype(np.float32),
            H.real.astype(np.float32), H.imag.astype(np.float32))


def rader_host_tables(p: int, pad: int) -> tuple:
    """(perm_in, src, Hr, Hi) for a prime-p Rader transform whose length
    p-1 cyclic convolution rides a transform at pad >= 2(p-1)-1: the
    primitive-root input permutation, the output gather (the convolution
    index serving each nonzero bin), and the padded spectrum of the
    kernel ``bq[q] = exp(-2 pi i g^{-q}/p)``.  The index tables are the
    reference's, built by running products instead of one ``pow`` an
    entry (the same integers)."""
    L = p - 1
    if pad < 2 * L - 1:
        raise ValueError(f"rader pad {pad} < 2(p-1)-1 = {2 * L - 1}")
    g = primitive_root(p)
    g_inv = pow(g, p - 2, p)

    def powers(base):
        out = np.empty(L, np.int64)
        v = 1
        for q in range(L):
            out[q] = v
            v = v * base % p
        return out

    perm_in = powers(g)
    dlog = np.zeros(p, np.int64)
    dlog[perm_in] = np.arange(L, dtype=np.int64)
    # X[k] (k >= 1) = x[0] + C[m] with g^{-m} = k: m = -dlog[k] mod L
    src = (L - dlog[1:]) % L
    roots = powers(g_inv)
    ang = 2.0 * np.pi * roots.astype(np.float64) / float(p)
    bq = np.cos(ang) - 1j * np.sin(ang)
    # cyclic period L: the negative lags [-(L-1)..-1] wrap to bq[1..L-1]
    full = np.concatenate([bq, bq[1:]])
    H = _circ_kernel_spectrum(full, pad)
    return (perm_in.astype(np.int32), src.astype(np.int32),
            H.real.astype(np.float32), H.imag.astype(np.float32))


def mixedradix_host_tables(n: int, m: int, n2: int) -> tuple:
    """(Dr, Di, Tr, Ti) float32 arrays: the m x m odd-axis DFT matrix and
    the (m, n2) twiddles of the split n = m * n2."""
    j1 = np.arange(m, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(j1, j1) / float(m)
    k1 = np.arange(m, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    tang = 2.0 * np.pi * np.outer(k1, j2) / float(n)
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32),
            np.cos(tang).astype(np.float32),
            (-np.sin(tang)).astype(np.float32))


def _on(device, arrays) -> tuple:
    """The host arrays as tensors on `device` (index tables as int64)."""
    return tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a).to(device) for a in arrays)


def bluestein_tables(n: int, pad: int, precision: Optional[str] = None,
                     device="cuda") -> tuple:
    """``bluestein_host_tables`` on `device`, cached per (n, pad,
    precision, device)."""
    dev = torch.device(device)
    return _cached_tables(
        ("bluestein", n, pad, "c2c", precision or "split3", str(dev)),
        lambda: _on(dev, bluestein_host_tables(n, pad)))


def rader_tables(p: int, pad: int, precision: Optional[str] = None,
                 device="cuda") -> tuple:
    """``rader_host_tables`` on `device`, cached like the chirp."""
    dev = torch.device(device)
    return _cached_tables(
        ("rader", p, pad, "c2c", precision or "split3", str(dev)),
        lambda: _on(dev, rader_host_tables(p, pad)))


def mixedradix_tables(n: int, m: int, n2: int, device="cuda") -> tuple:
    """``mixedradix_host_tables`` on `device`, cached per device."""
    dev = torch.device(device)
    return _cached_tables(
        ("mixedradix", n, m, n2, str(dev)),
        lambda: _on(dev, mixedradix_host_tables(n, m, n2)))


def _per_device(tables: Callable) -> Callable:
    """planes -> `tables(device)` for the device the planes lie on,
    resolved once per device: an executor's calls after the first touch
    no cache."""
    held = {}

    def get(x):
        got = held.get(x.device)
        if got is None:
            got = held[x.device] = tables(x.device)
        return got

    return get


# --- sub-executors --------------------------------------------------------


def _sub_executor(key, n: int, batch_extra: tuple,
                  mode: Optional[str]) -> Callable:
    """The (xr, xi) -> (yr, yi) forward c2c executor of an internal
    natural-order transform at `n` over the key's batch (plus
    `batch_extra` leading dims), resolved through the plan layer: a
    tuned or stored winner where there is one, else the static ladder."""
    from .. import plans

    sub = dataclasses.replace(key, n=n,
                              batch=tuple(key.batch) + batch_extra,
                              layout="natural", domain="c2c",
                              precision=mode or key.precision)
    device = "cpu" if plans.offline_kind(key.device_kind) else "cuda"
    return plans.get_plan(sub, device).fn


def _padded_conv(sub_fn: Callable, inv_pad: float) -> Callable:
    """(ar, ai, Hr, Hi) -> the circular convolution at the pad through
    ONE forward subplan: transform, multiply by the kernel spectrum, and
    the inverse by the conj trick on the same executor."""

    def run(ar, ai, hr, hi):
        fr, fi = sub_fn(ar, ai)
        yr = fr * hr - fi * hi
        yi = fr * hi + fi * hr
        wr, wi = sub_fn(yr, -yi)
        return wr * inv_pad, -wi * inv_pad

    return run


def _pad_to(xr, xi, pad: int):
    w = pad - xr.shape[-1]
    return F.pad(xr, (0, w)), F.pad(xi, (0, w))


# --- c2c executors --------------------------------------------------------


def bluestein_executor(key, params: dict) -> Callable:
    """The chirp-z c2c executor for any-n `key`: chirp multiply, one
    padded circular convolution, chirp multiply, first n outputs."""
    n = key.n
    mode = params.get("precision") or key.precision
    pad = int(params.get("pad") or default_pad(n))
    if pad < 2 * n - 1:
        raise ValueError(f"bluestein pad {pad} < 2n-1 = {2 * n - 1} "
                         f"for n={n}")
    tables = _per_device(lambda dev: bluestein_tables(n, pad, mode, dev))
    conv = _padded_conv(_sub_executor(key, pad, (), mode), 1.0 / pad)

    def run(xr, xi):
        br, bi, hr, hi = tables(xr)
        ar = xr * br - xi * bi
        ai = xr * bi + xi * br
        ar, ai = _pad_to(ar, ai, pad)
        wr, wi = conv(ar, ai, hr, hi)
        wr, wi = wr[..., :n], wi[..., :n]
        return wr * br - wi * bi, wr * bi + wi * br

    return run


def rader_executor(key, params: dict) -> Callable:
    """The prime-n Rader c2c executor: permute by the primitive root, one
    length n-1 cyclic convolution on the padded machinery, gather back
    to natural bin order, the DC bin as the input's sum."""
    p = key.n
    if not is_prime(p) or p < 3:
        raise ValueError(f"rader serves odd primes; n={p} is not one")
    mode = params.get("precision") or key.precision
    L = p - 1
    pad = int(params.get("pad") or default_pad(L))
    tables = _per_device(lambda dev: rader_tables(p, pad, mode, dev))
    conv = _padded_conv(_sub_executor(key, pad, (), mode), 1.0 / pad)

    def run(xr, xi):
        perm_in, src, hr, hi = tables(xr)
        ar, ai = _pad_to(xr.index_select(-1, perm_in),
                         xi.index_select(-1, perm_in), pad)
        cr, ci = conv(ar, ai, hr, hi)
        tr = xr[..., :1] + cr[..., :L].index_select(-1, src)
        ti = xi[..., :1] + ci[..., :L].index_select(-1, src)
        return (torch.cat([xr.sum(-1, keepdim=True), tr], -1),
                torch.cat([xi.sum(-1, keepdim=True), ti], -1))

    return run


def mixedradix_executor(key, params: dict) -> Callable:
    """The composite-n executor for n = m * 2^a (odd m): the odd axis's
    DFT by matrix product, twiddle, one BATCHED power-of-two subplan
    over the even axis at the key (2^a, batch + (m,)), index merge."""
    n = key.n
    a, m = odd_split(n)
    if m == 1:
        raise ValueError(f"n={n} is a power of two — not a mixedradix "
                         f"shape")
    if m > MIXEDRADIX_MAX_ODD:
        raise ValueError(f"mixedradix odd factor m={m} exceeds "
                         f"{MIXEDRADIX_MAX_ODD} — use bluestein")
    n2 = 1 << a
    mode = params.get("precision") or key.precision
    tables = _per_device(lambda dev: mixedradix_tables(n, m, n2, dev))
    sub_fn = _sub_executor(key, n2, (m,), mode) if n2 > 1 else None

    def run(xr, xi):
        dr, di, tr, ti = tables(xr)
        batch = xr.shape[:-1]
        ar = xr.reshape(batch + (m, n2))
        ai = xi.reshape(batch + (m, n2))
        # odd-axis DFT: B[k1, j2] = sum_j1 D[k1, j1] A[j1, j2]
        br = torch.matmul(dr, ar) - torch.matmul(di, ai)
        bi = torch.matmul(dr, ai) + torch.matmul(di, ar)
        # twiddle: C[k1, j2] = B[k1, j2] W_n^{j2 k1}
        cr = br * tr - bi * ti
        ci = br * ti + bi * tr
        if sub_fn is not None:
            cr, ci = sub_fn(cr, ci)
        # X[k1 + m k2] = D[k1, k2]: flat index k2 * m + k1
        return (cr.transpose(-1, -2).reshape(batch + (n,)),
                ci.transpose(-1, -2).reshape(batch + (n,)))

    return run


# --- odd-n real executors -------------------------------------------------


def rfft_odd_executor(key, variant: str, params: dict) -> Callable:
    """The odd-n r2c executor: no even/odd pack exists, so the any-length
    c2c at n runs on the real plane and keeps the n//2+1 leading bins."""
    c2c = build_anylen_executor(key, variant, params, _force_c2c=True)
    bins = key.n // 2 + 1

    def run(xr, xi):
        del xi  # real by declaration (domain="r2c")
        yr, yi = c2c(xr, torch.zeros_like(xr))
        return yr[..., :bins], yi[..., :bins]

    return run


def irfft_odd_executor(key, variant: str, params: dict) -> Callable:
    """The odd-n c2r executor: the full Hermitian spectrum from the
    n//2+1 stored bins (X[n-k] = conj(X[k])), one inverse any-length c2c
    at n by the conj trick, the real plane."""
    c2c = build_anylen_executor(key, variant, params, _force_c2c=True)
    inv_n = 1.0 / key.n

    def run(xr, xi):
        fr = torch.cat([xr, xr[..., 1:].flip(-1)], -1)
        fi = torch.cat([xi, -xi[..., 1:].flip(-1)], -1)
        wr, _ = c2c(fr, -fi)  # IFFT_n = conj(FFT_n(conj(X))) / n
        yr = wr * inv_n
        return yr, torch.zeros_like(yr)

    return run


def build_anylen_executor(key, variant: str, params: dict,
                          _force_c2c: bool = False) -> Callable:
    """Ladder dispatch for the any-length variants (from
    ``plans.ladder.build_executor``).  Raises ValueError for statically
    infeasible combinations, which the tuner records as rejections."""
    if key.layout != "natural":
        raise ValueError(
            f"variant {variant!r} produces natural order only (pi order "
            f"is per-transform bit reversal — power-of-two n)")
    if not _force_c2c and key.domain != "c2c":
        # only odd n lands here: even real domains ride the half-length
        # c2c subkey (plans.ladder.c2c_subkey)
        if key.domain == "r2c":
            return rfft_odd_executor(key, variant, params)
        return irfft_odd_executor(key, variant, params)
    if variant == "bluestein":
        return bluestein_executor(key, params)
    if variant == "rader":
        return rader_executor(key, params)
    if variant == "mixedradix":
        return mixedradix_executor(key, params)
    raise ValueError(f"unknown any-length variant {variant!r}")
