"""Fused spectral convolution / correlation on the plan layer (the
reference's ``apps/spectral.py``).

The convolution theorem makes filtering three transforms and one
elementwise multiply, and on memory-bound kernels the whole game is
keeping that multiply on the card, in the half-spectrum, between the
paired transforms:

    y = irfft( rfft(x) · rfft(k) )          (conv)
    c = irfft( rfft(x) · conj(rfft(k)) )    (corr)

Everything here composes the plan layer's real-domain executors
(``plans.plan_for(..., domain="r2c"/"c2r")``, ``models/real.py``): the
forward and inverse plans' ``fn``s are closed over in one cached
callable per (op, n, precision, device), so the half-spectrum lives in
device memory for exactly the life of the pointwise multiply and never
goes through the host (``tests/test_torch_apps.py`` holds that by AST;
the ``apps --smoke`` meter gate catches it from the bytes meter).  The
multiply is torch elementwise work, as the reference's is a ``jnp``
product outside any kernel.  Repeated filtering with one kernel pays
ONE forward transform: the kernel spectrum is cached per (kernel hash,
n, domain, precision) and per device.

Linear convolution (``numpy.convolve`` / ``numpy.correlate`` parity)
rides the circular core by padding to the cheapest feasible length >=
len(x)+len(k)-1 (``cheapest_length``) and slicing the mode's window.
The circular core is also what :func:`op_executor` serves to an
op-tagged batch, with ``torch-fft`` and ``numpy-ref`` rungs that speak
each op natively for planes on the CPU.

Numpy in gives numpy out; a tensor in gives a tensor out on its own
device.  Numpy input goes to `device`, the card by default.  While
observability is armed each op runs under a ``spectral_op`` span and
counts on ``pifft_apps_ops_total{op}``, kernel-spectrum cache lookups on
``pifft_apps_kspec_cache_total{result}``, and op traffic on the
roofline's bytes meter (``utils.roofline.charge_spectral_traffic``).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .. import plans
from ..obs import metrics
from ..obs.spans import span
from ..resilience.degrade import LIBRARY_RUNGS
from ..utils.device import as_plane, resolve_device
from ..utils.roofline import SPECTRAL_OPS as OPS
from ..utils.roofline import charge_spectral_traffic


def check_op(op: str) -> str:
    """Validate an op name, returning it; raises ``ValueError`` naming
    the vocabulary."""
    if op not in OPS:
        raise ValueError(f"op={op!r} not in {OPS}")
    return op


def next_pow2(v: int) -> int:
    """Smallest power of two >= max(v, 2)."""
    n = 2
    while n < v:
        n *= 2
    return n


#: odd parts the conv length chooser considers: 2^a * odd for these
#: has a cheap mixed-radix plan (``ops.anylen``), so the chooser lands
#: under the next power of two without ever picking a chirp-padded length
_CHEAP_ODD_PARTS = (1, 3, 5, 9, 15)


def cheapest_length(v: int) -> int:
    """The cheapest feasible transform length >= v for the linear
    conv/corr pipeline: spectral traffic scales with n, so the smallest
    even ``odd * 2^a`` >= v over the mixed-radix-cheap odd parts.  A
    power-of-two v returns v."""
    best = next_pow2(v)
    for odd in _CHEAP_ODD_PARTS[1:]:
        m = odd * 2  # even, so the r2c pack trick always applies
        while m < v:
            m *= 2
        if m < best:
            best = m
    return best


def _mul_half_spectrum(ar, ai, br, bi, conj: bool):
    """(a · b) or (a · conj(b)) on split half-spectrum planes."""
    if conj:
        return ar * br + ai * bi, ai * br - ar * bi
    return ar * br - ai * bi, ar * bi + ai * br


def poisson_multiplier_1d(n: int) -> np.ndarray:
    """The 1-D periodic Poisson symbol on the n//2+1 half-spectrum bins:
    u'' = f on [0, 2*pi) -> u_hat = -f_hat / k^2, zero mode -> 0."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        m = np.where(k > 0, -1.0 / np.maximum(k * k, 1e-30), 0.0)
    return m.astype(np.float32)


def _device(device=None, like=None) -> torch.device:
    """Where an op runs: `device` if given, else the device of the
    tensor `like`, else the card; a bare "cuda" gets the current card's
    index, so every cache below keys one card one way."""
    if device is None and isinstance(like, torch.Tensor):
        return like.device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _like(y, ref):
    """`y` (a tensor) as the caller gave `ref`: numpy for numpy, else a
    tensor on `ref`'s device."""
    if isinstance(ref, torch.Tensor):
        return y.to(ref.device)
    return y.cpu().numpy()


def _signal(x, device=None):
    """A float32 plane of real `x` on `device`, else on its own device
    (a tensor) or the card (numpy)."""
    return as_plane(x, _device(device, x))


def _host_kernel(k) -> np.ndarray:
    """The kernel's float32 values on the host: its hash and length are
    host facts.  The kernel is the filter's taps, never a spectrum."""
    if isinstance(k, torch.Tensor):
        k = k.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(k, np.float32))


# ------------------------------------------------ kernel-spectrum cache

_KSPEC_LOCK = threading.Lock()
_KSPEC_CACHE: dict = {}

#: bound on cached kernel spectra; past it the least recently used goes
KSPEC_CACHE_MAX = 64


def _kernel_hash(k: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(k, np.float32)
                        .tobytes()).hexdigest()


def kernel_spectrum(k, n: int, precision: Optional[str] = None,
                    device=None) -> tuple:
    """The half-spectrum planes of `k` zero-padded to `n`, through the
    r2c plan at n on `device` (a tensor kernel's own device by default,
    else the card), cached per (kernel hash, n, domain, precision,
    device) so repeated filtering with one kernel pays ONE forward
    transform.  The planes stay on the device."""
    dev = _device(device, k)
    kh = _host_kernel(k)
    if kh.ndim != 1 or not 1 <= kh.shape[0] <= n:
        raise ValueError(f"kernel must be 1-D with 1 <= len <= n={n}, "
                         f"got shape {kh.shape}")
    ck = (_kernel_hash(kh), n, "r2c", precision or "split3", str(dev))
    with _KSPEC_LOCK:
        hit = _KSPEC_CACHE.pop(ck, None)
        if hit is not None:
            _KSPEC_CACHE[ck] = hit  # re-append: LRU recency
    if hit is not None:
        metrics.inc("pifft_apps_kspec_cache_total", result="hit")
        return hit
    metrics.inc("pifft_apps_kspec_cache_total", result="miss")
    kp = torch.zeros(n, dtype=torch.float32, device=dev)
    kp[: kh.shape[0]] = torch.from_numpy(kh).to(dev)
    rfft_plan = plans.plan_for((n,), layout="natural", precision=precision,
                               domain="r2c", device=dev)
    kr, ki = rfft_plan.execute(kp, kp)
    with _KSPEC_LOCK:
        _KSPEC_CACHE[ck] = (kr, ki)
        while len(_KSPEC_CACHE) > KSPEC_CACHE_MAX:
            _KSPEC_CACHE.pop(next(iter(_KSPEC_CACHE)))
    return kr, ki


def kernel_spectrum_cache_clear() -> None:
    """Drop the cached kernel spectra (tests, memory pressure)."""
    with _KSPEC_LOCK:
        _KSPEC_CACHE.clear()


# ------------------------------------------------- fused circular core

#: fused callables per (op, batch or n, precision, device): the
#: reference's jitted programs; each holds its plan pair
_FUSED_LOCK = threading.Lock()
_FUSED_CACHE: dict = {}


def fused_cache_clear() -> None:
    """Drop the cached fused callables and the plans they hold (after
    the plan store changed, so the next op resolves its plans anew)."""
    with _FUSED_LOCK:
        _FUSED_CACHE.clear()


def _plan_pair(shape: tuple, precision: Optional[str], device) -> tuple:
    """(r2c plan, c2r plan) for real planes of `shape`: the inverse at
    the forward plan's EFFECTIVE precision, so a promotion
    (``resilience.degrade.promote_precision``) serves both directions."""
    fwd = plans.plan_for(shape, layout="natural", precision=precision,
                         domain="r2c", device=device)
    inv = plans.plan_for(shape, layout="natural",
                         precision=fwd.effective_precision(), domain="c2r",
                         device=device)
    return fwd, inv


def _poisson_multiplier_on(n: int, device) -> torch.Tensor:
    return torch.from_numpy(poisson_multiplier_1d(n)).to(device)


def _build_fused(op: str, batch: tuple, n: int, precision: Optional[str],
                 device) -> tuple:
    """(run(xr, xi) -> (yr, yi), forward plan) for one op at the
    transform length n over `batch` leading dims on `device`: rfft of
    each operand, the pointwise half-spectrum multiply, irfft, the
    spectrum never leaving the card.

    conv/corr: ``xr`` is the signal plane(s), ``xi`` the kernel
    plane(s), both real.  solve: ``xr`` is the field, ``xi`` ignored;
    the multiplier is the 1-D periodic Poisson symbol."""
    fwd, inv = _plan_pair(tuple(batch) + (n,), precision, device)
    if op == "solve":
        mult = _poisson_multiplier_on(n, device)

        def solve_run(xr, xi):
            del xi  # the field is real by declaration
            ar, ai = fwd.fn(xr, xr)
            return inv.fn(ar * mult, ai * mult)

        return solve_run, fwd
    conj = op == "corr"

    def run(xr, xi):  # xr = signal plane(s), xi = kernel plane(s)
        ar, ai = fwd.fn(xr, xr)
        br, bi = fwd.fn(xi, xi)
        pr, pi = _mul_half_spectrum(ar, ai, br, bi, conj)
        return inv.fn(pr, pi)

    return run, fwd


def _on_card(plane) -> bool:
    """True for a plane the library rungs must not serve."""
    return plane.device.type != "cpu"


def _refuse_card_planes(rung: str, plane) -> None:
    if _on_card(plane):
        raise ValueError(
            f"the {rung} rung serves CPU planes only, got a plane on "
            f"{plane.device}: on the card an op is served by the fused "
            f"pipeline on the Hopper kernels")


def op_executor(op: str, batch: tuple, n: int,
                precision: Optional[str] = None,
                rung: Optional[str] = None, device=None) -> tuple:
    """(callable, plan) serving one op-tagged group: the fused pipeline
    (rung None) or a degradation rung that speaks the OP natively —
    ``torch-fft`` through ``torch.fft.rfft/irfft``, ``numpy-ref``
    through the float64 numpy oracle — so a fallback stays the same
    operation.  The library rungs serve CPU planes only and raise for
    planes on the card, as ``resilience.degrade.rungs_for`` keeps them
    off it.  The callable takes and returns float32 planes (tensors);
    the plan is the forward r2c plan."""
    check_op(op)
    if op == "fft":
        raise ValueError("op='fft' is the plain transform: it is served "
                         "by the plan executor, not an op pipeline")
    dev = _device(device)
    shape = tuple(batch) + (n,)
    if rung is None:
        return _build_fused(op, tuple(batch), n, precision, dev)
    fwd_plan = plans.plan_for(shape, layout="natural", precision=precision,
                              domain="r2c", device=dev)
    torch_rung, numpy_rung = LIBRARY_RUNGS
    if rung == torch_rung:
        mult = _poisson_multiplier_on(n, dev) if op == "solve" else None
        conj = op == "corr"

        def torch_fft_run(xr, xi):
            _refuse_card_planes(rung, xr)
            a = torch.fft.rfft(xr.float(), dim=-1)
            if op == "solve":
                s = a * mult
            else:
                b = torch.fft.rfft(xi.float(), dim=-1)
                s = a * (torch.conj(b) if conj else b)
            yr = torch.fft.irfft(s, n=n, dim=-1).float()
            return yr, torch.zeros_like(yr)

        return torch_fft_run, fwd_plan
    if rung == numpy_rung:
        def numpy_run(xr, xi):
            _refuse_card_planes(rung, xr)
            yr = numpy_oracle(op, xr.numpy(), xi.numpy(), n)
            out = torch.from_numpy(np.ascontiguousarray(yr, np.float32))
            return out, torch.zeros_like(out)

        return numpy_run, fwd_plan
    raise ValueError(f"unknown op rung {rung!r}")


def numpy_oracle(op: str, xr, xi, n: int) -> np.ndarray:
    """The float64 numpy reference of one CIRCULAR op at n.  ``xr``/``xi``
    follow the op's plane contract (signal/kernel for conv and corr;
    field/ignored for solve); the trailing axis is the transform axis."""
    check_op(op)
    x64 = np.asarray(xr, np.float64)
    if op == "solve":
        return np.fft.irfft(
            np.fft.rfft(x64, axis=-1)
            * poisson_multiplier_1d(n).astype(np.float64),
            n=n, axis=-1)
    k64 = np.asarray(xi, np.float64)
    spec = np.fft.rfft(x64, axis=-1) * (
        np.conj(np.fft.rfft(k64, axis=-1)) if op == "corr"
        else np.fft.rfft(k64, axis=-1))
    return np.fft.irfft(spec, n=n, axis=-1)


def _fused_circular(op: str, n: int, precision: Optional[str],
                    device) -> Callable:
    """The cached single-signal fused circular pipeline at n on
    `device`: conv/corr against a PRE-TRANSFORMED kernel spectrum (the
    cache's planes are arguments, so one callable serves every kernel):
    run(signal plane, kr, ki) -> the real output plane."""
    dev = _device(device)
    ck = (op, n, precision or "split3", str(dev))
    with _FUSED_LOCK:
        hit = _FUSED_CACHE.get(ck)
    if hit is not None:
        return hit
    fwd, inv = _plan_pair((n,), precision, dev)
    conj = op == "corr"

    def run(xp, kr, ki):
        ar, ai = fwd.fn(xp, xp)
        pr, pi = _mul_half_spectrum(ar, ai, kr, ki, conj)
        yr, _ = inv.fn(pr, pi)
        return yr

    with _FUSED_LOCK:
        _FUSED_CACHE[ck] = run
    return run


def circular_conv(x, k, op: str = "conv", precision: Optional[str] = None,
                  n: Optional[int] = None, device=None):
    """Circular convolution (or correlation, ``op="corr"``) of real 1-D
    `x` with real `k` at any length ``n >= 2`` (default: len(x)): the
    fused primitive.  Lengths that are not powers of two ride the
    any-length plans through the same pipeline.  The kernel spectrum
    comes from the cache; the half-spectrum product never leaves the
    device."""
    if op not in ("conv", "corr"):
        raise ValueError(f"circular_conv serves conv/corr, not {op!r}")
    xt = _signal(x, device)
    if xt.ndim != 1:
        raise ValueError(f"signal must be 1-D, got shape {tuple(xt.shape)}")
    n = int(n) if n is not None else xt.shape[0]
    if n < 2:
        raise ValueError(f"circular length n={n} must be >= 2")
    if xt.shape[0] > n:
        raise ValueError(f"signal of {xt.shape[0]} exceeds n={n}")
    kr, ki = kernel_spectrum(k, n, precision, xt.device)
    if xt.shape[0] < n:
        xt = torch.nn.functional.pad(xt, (0, n - xt.shape[0]))
    fused = _fused_circular(op, n, precision, xt.device)
    with span("spectral_op", cell={"op": op, "n": n}):
        y = fused(xt, kr, ki)
        metrics.inc("pifft_apps_ops_total", op=op)
        charge_spectral_traffic(op, n)
    return _like(y, x)


def _mode_slice(full, la: int, lv: int, mode: str, op: str):
    """Slice a full linear conv/corr (length la+lv-1) into numpy's mode
    windows.  ``same`` follows numpy: length max(la, lv), centered, with
    correlate's swapped-operand convention (``numpy.correlate(a, v)``
    with len(v) > len(a) computes the reversed correlate(v, a), which
    shifts the window start by one when the shorter length is even)."""
    if mode == "full":
        return full
    if mode == "same":
        out_len = max(la, lv)
        if op == "corr" and lv > la:
            start = (la - 1) - (la - 1) // 2
        else:
            start = (min(la, lv) - 1) // 2
        return full[start:start + out_len]
    if mode == "valid":
        out_len = max(la, lv) - min(la, lv) + 1
        start = min(la, lv) - 1
        return full[start:start + out_len]
    raise ValueError(f"mode={mode!r} not in ('full', 'same', 'valid')")


def _lengths(xt, k) -> tuple:
    lv = k.shape[-1] if isinstance(k, torch.Tensor) else np.shape(k)[-1]
    return xt.shape[-1], int(lv)


def fftconv(x, k, mode: str = "full", precision: Optional[str] = None,
            device=None):
    """Linear convolution of real 1-D `x` with real 1-D `k` through the
    fused spectral pipeline: ``numpy.convolve(x, k, mode)`` parity at
    O(n log n).  Pads to ``cheapest_length(len(x)+len(k)-1)``, runs the
    fused circular core (one cached kernel transform, the pointwise
    multiply on the device) and slices the mode window."""
    xt = _signal(x, device)
    la, lv = _lengths(xt, k)
    n = cheapest_length(la + lv - 1)
    full = circular_conv(xt, k, "conv", precision, n)[: la + lv - 1]
    return _like(_mode_slice(full, la, lv, mode, "conv").contiguous(), x)


def fftcorr(x, k, mode: str = "full", precision: Optional[str] = None,
            device=None):
    """Cross-correlation of real 1-D `x` with real 1-D `k`:
    ``numpy.correlate(x, k, mode)`` parity through the conjugated kernel
    spectrum.  The negative lags live at the top of the circular
    buffer; the full window puts them back in numpy's order."""
    xt = _signal(x, device)
    la, lv = _lengths(xt, k)
    n = cheapest_length(la + lv - 1)
    circ = circular_conv(xt, k, "corr", precision, n)
    # full output lag t - (lv-1), t = 0..la+lv-2: negative lags wrap
    full = torch.cat([circ[n - (lv - 1):], circ[:la]]) if lv > 1 \
        else circ[:la]
    return _like(_mode_slice(full, la, lv, mode, "corr").contiguous(), x)


def solve_spectral_1d(f, precision: Optional[str] = None, device=None):
    """The 1-D periodic Poisson solve (op="solve"): u'' = f on
    [0, 2*pi), mean-free, in one fused rfft·symbol·irfft pipeline over
    the trailing axis.  The full solver family lives in :mod:`.pde`."""
    ft = _signal(f, device)
    n = ft.shape[-1]
    batch = tuple(ft.shape[:-1])
    ck = ("solve", batch, n, precision or "split3", str(ft.device))
    with _FUSED_LOCK:
        fn = _FUSED_CACHE.get(ck)
    if fn is None:
        fn, _plan = _build_fused("solve", batch, n, precision, ft.device)
        with _FUSED_LOCK:
            _FUSED_CACHE[ck] = fn
    with span("spectral_op", cell={"op": "solve", "n": n}):
        yr, _ = fn(ft, ft)
        metrics.inc("pifft_apps_ops_total", op="solve")
        charge_spectral_traffic("solve", n)
    return _like(yr, f)


def fftconv_unfused(x, k, mode: str = "full",
                    precision: Optional[str] = None, device=None):
    """The DELIBERATELY UNFUSED control of the metered fusion gate: the
    math of :func:`fftconv`, but the half-spectrum product goes through
    the HOST between the paired transforms, the pattern the fused path
    exists to avoid, charged as one spectrum round trip so the metered
    bytes exceed the fused floor and the gate discriminates.  It keeps
    next-pow2 padding, so it is also the pad-to-pow2 control of the
    ``conv_np`` row at lengths that are not powers of two.  Never serve
    this."""
    from ..models.real import irfft_planes_fast, rfft_planes_fast

    xt = _signal(x, device)
    kt = as_plane(k, xt.device)
    la, lv = xt.shape[-1], kt.shape[-1]
    n = next_pow2(la + lv - 1)
    xp = torch.nn.functional.pad(xt, (0, n - la))
    kp = torch.nn.functional.pad(kt, (0, n - lv))
    ar, ai = rfft_planes_fast(xp, precision=precision)
    br, bi = rfft_planes_fast(kp, precision=precision)
    # the host round trip between the transforms: this control's purpose
    har, hai, hbr, hbi = (t.cpu().numpy() for t in (ar, ai, br, bi))
    pr = har * hbr - hai * hbi
    pi = har * hbi + hai * hbr
    yr = irfft_planes_fast(torch.from_numpy(pr).to(xt.device),
                           torch.from_numpy(pi).to(xt.device), n=n,
                           precision=precision)
    metrics.inc("pifft_apps_ops_total", op="conv")
    charge_spectral_traffic("conv", n, host_round_trips=1)
    full = yr[: la + lv - 1]
    return _like(_mode_slice(full, la, lv, mode, "conv").contiguous(), x)
