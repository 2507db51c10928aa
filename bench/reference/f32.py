"""float32 exp, log, log1p, expm1, sqrt and erf_inv evaluated operation by
operation as the sampler's reference evaluates them: the Cephes-derived
polynomials of Eigen's float32 code, with a fused multiply-add exactly where
that code fuses one, and denormals read as zero.  Every step is an IEEE
operation that PyTorch rounds alike on every device, so the exact-cell
acceptance alpha = exp(log p - log q), which is ill-conditioned in float32,
comes out bit for bit.
"""

from __future__ import annotations

import struct

import torch


def _c(hex_bits: str) -> float:
    """A float32 constant spelled as the hex of its double widening."""
    return struct.unpack(">d", bytes.fromhex(hex_bits))[0]


_MIN_NORMAL = _c("3810000000000000")
_LN2_HI = _c("3FE6300000000000")  # 0.693359375
_LN2_LO = _c("BF2BD01060000000")  # -2.12194440e-4
_SQRT_HALF = _c("3FE6A09E60000000")

_EXP_LO, _EXP_HI = _c("C055F33340000000"), _c("4056333340000000")
_LOG2E = _c("3FF7154760000000")
_EXP_P = [_c(h) for h in ("3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
                          "3FA5553820000000", "3FC5555540000000")]

_LOG_P = [_c(h) for h in ("3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
                          "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
                          "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]

_LOG1P_SMALL = _c("3FDA8279A0000000")  # sqrt(2) - 1
_LOG1P_DEN = [_c(h) for h in ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
                              "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM = [_c(h) for h in ("3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
                              "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
                              "40340A2020000000")]

# erf_inv: Giles' single-precision polynomials in w = -log1p(-x^2), one
# for w < 5 (in w - 2.5) and one for w >= 5 (in sqrt(w) - 3), leading
# coefficient first
_ERFINV_LT5 = [_c(h) for h in ("3E5E2CB100000000", "3E970966C0000000", "BECD8E6AE0000000",
                               "BED26B5820000000", "3F2CA65B60000000", "BF548A8100000000",
                               "BF711C9DE0000000", "3FCF91EC60000000", "3FF805C5E0000000")]
_ERFINV_GE5 = [_c(h) for h in ("BF2A3E1360000000", "3F1A76AD60000000", "3F561B8E40000000",
                               "BF6E17BCE0000000", "3F77824F60000000", "BF7F38BAE0000000",
                               "3F8354AFC0000000", "3FF006DB60000000", "4006A9EFC0000000")]

_TANH_TINY = _c("3F3A36E2E0000000")
_TANH_CLAMP = _c("401FFEC880000000")
_TANH_A = [_c(h) for h in ("BCB3E4B800000000", "3D4C266FC0000000", "BDD7A6FFE0000000",
                           "3E6B800820000000", "3EEF286940000000", "3F44E1BDA0000000",
                           "3F740B3B80000000")]
_TANH_B = [_c(h) for h in ("3EB41A7B00000000", "3F1F12BAC0000000", "3F629540A0000000",
                           "3F740B3BA0000000")]


def _in(x) -> torch.Tensor:
    """A float32 input with denormals read as zero, as the reference's code
    runs (flush-to-zero and denormals-are-zero)."""
    x = torch.as_tensor(x)
    if x.dtype != torch.float32:
        raise TypeError(f"float32 input expected, got {x.dtype}")
    return ftz(x)


def ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < _MIN_NORMAL, x * 0.0, x)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a hardware FMA rounds it.

    Evaluated in float64, where the product is exact; the sum's rounding is
    made round-to-odd (TwoSum gives its exact error), so the final rounding
    to float32 cannot round twice.  Inputs are float32 tensors or floats
    exactly representable in float32.
    """
    a64 = torch.as_tensor(a, dtype=torch.float64)
    b64 = torch.as_tensor(b, dtype=torch.float64)
    c64 = torch.as_tensor(c, dtype=torch.float64)
    p = a64 * b64
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)  # the exact sum lies farther from zero than s
    bits = torch.where(inexact_even, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x): x = n ln2 + r, a degree-7 polynomial in r, times 2^n."""
    x = torch.clamp(_in(x), _EXP_LO, _EXP_HI)
    fx = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(fx, -_LN2_LO, fma(fx, -_LN2_HI, x))
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + [0.5]:
        p = fma(p, r, c)
    y = fma(p, r * r, r) + 1.0
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(y * pow2)


def _log_core(x: torch.Tensor) -> torch.Tensor:
    """log of a positive normal float: frexp, then a degree-9 polynomial."""
    bits = torch.clamp_min(x, _MIN_NORMAL).view(torch.int32)
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    x1 = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = x1 * x1
    x3 = x2 * x1
    P = _LOG_P
    y = fma(fma(x1, P[0], P[1]), x1, P[2])
    y1 = fma(fma(x1, P[3], P[4]), x1, P[5])
    y2 = fma(fma(x1, P[6], P[7]), x1, P[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _LN2_LO)
    return fma(e, _LN2_HI, fma(x2, -0.5, x1) + y)


def _log_special(x: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    out = torch.where(x > 0, core, torch.full_like(core, float("nan")))
    out = torch.where(x == 0, torch.full_like(core, float("-inf")), out)
    return torch.where(x == float("inf"), x, out)


def log(x: torch.Tensor) -> torch.Tensor:
    x = _in(x)
    return _log_special(x, _log_core(x))


def log1p(x: torch.Tensor) -> torch.Tensor:
    """log(1 + x): a rational approximation for |x| < sqrt(2) - 1, else log."""
    x = _in(x)
    u = x + 1.0
    big = _log_special(u, _log_core(u))
    den = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    num = fma(x, _LOG1P_NUM[0], _LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        num = fma(num, x, c)
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, big)


def _tanh(h: torch.Tensor) -> torch.Tensor:
    hc = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    h2 = hc * hc
    p = fma(h2, _TANH_A[0], _TANH_A[1])
    for c in _TANH_A[2:]:
        p = fma(h2, p, c)
    q = fma(h2, _TANH_B[0], _TANH_B[1])
    for c in _TANH_B[2:]:
        q = fma(h2, q, c)
    t = torch.where(torch.abs(h) < _TANH_TINY, h, (hc * p) / q)
    return torch.where(torch.abs(h) >= 20.0, torch.copysign(torch.ones_like(h), h), t)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """exp(x) - 1 for |x| > 1/2, else tanh(x / 2) * (exp(x) + 1)."""
    raw = torch.as_tensor(x)
    x = _in(raw)
    e = exp(x)
    h = x * 0.5
    out = torch.where(torch.abs(x) > 0.5, e - 1.0, _tanh(h) * (e + 1.0))
    return torch.where(h == 0, raw, out)  # tiny inputs pass through as given


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  PyTorch's vectorised float32
    sqrt on the CPU can be one ulp off; the float64 root rounded to float32
    is the IEEE result (53 >= 2 * 24 + 2 bits, so the double rounding is
    harmless) on every device."""
    return torch.sqrt(torch.as_tensor(x).double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function on (-1, 1), +-inf at +-1: w = -log1p(-x^2),
    a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5) by
    Horner's rule with fused multiply-adds, times x."""
    x = _in(x)
    w = -log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, t, torch.where(lt, a, b))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)
