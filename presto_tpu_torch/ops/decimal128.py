"""Long-decimal (wide) arithmetic as two int64 lanes.

Counterpart of presto_tpu/ops/decimal128.py with the same lane layout and
rounding, so values carry over between the packages bit for bit. It is the
stand-in for the reference's 128-bit unscaled decimal
(presto-spi/.../type/UnscaledDecimal128Arithmetic.java, Decimals.java):
DECIMAL(p>18) values are stored as TWO int64 lanes per row —
``value = hi * 2**32 + lo`` with canonical ``lo in [0, 2**32)`` and signed
``hi`` — radix-2^32 limbs chosen so every add/merge stays exact in int64.

Block layout: ``data.shape == (capacity, 2)``, lane 0 = hi, lane 1 = lo.
Representable magnitude ~2^95 (≈ 4e28) — the SQL type is decimal(38, s)
for parity with the reference; values beyond 2^95 are out of range the
same way the reference overflows beyond 10^38.

Canonicalization (`dnorm`) uses arithmetic shifts (torch's `>>` on int64 is
arithmetic), so it is correct for negative intermediate lo lanes.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
RADIX_BITS = 32


def dnorm(hi, lo):
    """Canonicalize lanes: fold lo's overflow (or borrow) into hi."""
    carry = lo >> RADIX_BITS  # arithmetic shift = floor(lo / 2^32)
    return hi + carry, lo & MASK32


def from_int64(x):
    """Widen an int64 column to lanes, shape (..., 2)."""
    return torch.stack([x >> RADIX_BITS, x & MASK32], dim=-1)


def to_int64(lanes):
    """Narrow lanes to int64. Exact when |value| < 2^63; wraps beyond."""
    return lanes[..., 0] * (MASK32 + 1) + lanes[..., 1]


def dneg(lanes):
    hi, lo = lanes[..., 0], lanes[..., 1]
    return torch.stack(dnorm(-hi, -lo), dim=-1)


def dadd(a, b):
    hi, lo = dnorm(a[..., 0] + b[..., 0], a[..., 1] + b[..., 1])
    return torch.stack([hi, lo], dim=-1)


def dsub(a, b):
    hi, lo = dnorm(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    return torch.stack([hi, lo], dim=-1)


def dcmp_lt(a, b):
    ah, al, bh, bl = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    return (ah < bh) | ((ah == bh) & (al < bl))


def dcmp_eq(a, b):
    return (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def dsign(lanes):
    hi, lo = lanes[..., 0], lanes[..., 1]
    one = torch.ones_like(hi)
    zero = (hi == 0) & (lo == 0)
    return torch.where(zero, 0 * one, torch.where(hi < 0, -one, one))


def dabs(lanes):
    return torch.where((lanes[..., 0] < 0)[..., None], dneg(lanes), lanes)


def dmul_int64(lanes, c):
    """Exact lanes * int64 (|result| must stay < 2^95; beyond that the top
    limb is dropped, mirroring unchecked overflow of the narrow path).

    Schoolbook 32-bit limb multiply: value = v2*2^64 + v1*2^32 + v0 times
    c = c1*2^32 + c0. Every partial product is split into 32-bit halves
    before accumulation so all arithmetic stays exact in int64."""
    c = torch.as_tensor(c, dtype=torch.int64, device=lanes.device)
    sign = dsign(lanes) * torch.sign(torch.where(c == 0, 1, c))
    a = dabs(lanes)
    cmag = torch.abs(c)
    v0 = a[..., 1]
    v1 = a[..., 0] & MASK32
    v2 = (a[..., 0] >> RADIX_BITS) & MASK32
    c0 = cmag & MASK32
    c1 = (cmag >> RADIX_BITS) & MASK32

    def halves(x, y):
        # x, y < 2^32 -> x*y < 2^64: compute exactly via 16-bit splits of x
        xl = x & 0xFFFF
        xh = x >> 16
        lo_p = xl * y  # < 2^48
        hi_p = xh * y  # < 2^48, weight 2^16
        t = lo_p + ((hi_p & 0xFFFF) << 16)
        lo = t & MASK32
        hi = (hi_p >> 16) + (t >> RADIX_BITS)
        return hi, lo  # x*y == hi*2^32 + lo, both < 2^32

    r0 = torch.zeros_like(v0)
    r1 = torch.zeros_like(v0)
    r2 = torch.zeros_like(v0)
    for vi, shift in ((v0, 0), (v1, 1), (v2, 2)):
        for cj, cshift in ((c0, 0), (c1, 1)):
            ph, pl = halves(vi, cj)
            k = shift + cshift
            if k == 0:
                r0 = r0 + pl
                r1 = r1 + ph
            elif k == 1:
                r1 = r1 + pl
                r2 = r2 + ph
            elif k == 2:
                r2 = r2 + pl
            # k >= 3 exceeds 2^96: dropped (out of supported range)
    r1 = r1 + (r0 >> RADIX_BITS)
    r0 = r0 & MASK32
    r2 = r2 + (r1 >> RADIX_BITS)
    r1 = r1 & MASK32
    hi = (r2 << RADIX_BITS) | r1
    mag = torch.stack([hi, r0], dim=-1)
    return torch.where((sign < 0)[..., None], dneg(mag), mag)


def _divmod_nonneg(lanes_nonneg, d):
    """(quotient lanes, remainder int64) for non-negative lanes, 0<d<2^31."""
    ahi, alo = lanes_nonneg[..., 0], lanes_nonneg[..., 1]
    q1 = ahi // d
    r1 = ahi - q1 * d
    num2 = (r1 << RADIX_BITS) + alo  # < d*2^32 + 2^32 <= 2^63 for d < 2^31
    q2 = num2 // d
    r2 = num2 - q2 * d
    return torch.stack([q1, q2], dim=-1), r2


def ddiv_lanes_half_up(lanes, d):
    """lanes / d as lanes, HALF_UP (away from zero); 0 < d < 2^31."""
    sign_neg = lanes[..., 0] < 0
    q, r2 = _divmod_nonneg(dabs(lanes), d)
    bump = (2 * r2 >= d).to(torch.int64)
    hi, lo = dnorm(q[..., 0], q[..., 1] + bump)
    q = torch.stack([hi, lo], dim=-1)
    return torch.where(sign_neg[..., None], dneg(q), q)


def ddiv_int64_half_up(lanes, d):
    """lanes / d narrowed to int64, HALF_UP; 0 < d < 2^31."""
    return to_int64(ddiv_lanes_half_up(lanes, d))


def rescale(lanes, pow10: int):
    """Multiply lanes by 10**pow10. Negative pow10 divides with HALF_UP
    rounding (SQL rescale semantics, reference Decimals.java)."""
    out = lanes
    p = pow10
    while p > 0:
        step = min(p, 18)
        out = dmul_int64(out, 10**step)
        p -= step
    while p < 0:
        # all but the last step truncate toward zero, the last rounds HALF_UP
        step = min(-p, 9)
        d = 10**step
        if -p > 9:
            neg = out[..., 0] < 0
            q, _ = _divmod_nonneg(dabs(out), d)
            out = torch.where(neg[..., None], dneg(q), q)
        else:
            out = ddiv_lanes_half_up(out, d)
        p += step
    return out


def ddiv_wide(lanes, d):
    """lanes / d for arbitrary int64 divisors (|d| up to ~2^62), HALF_UP.

    Float64 quotient estimate + exact lane-space remainder correction;
    exact for |quotient| < 2^53. Returns int64."""
    d = torch.as_tensor(d, dtype=torch.int64, device=lanes.device)
    sign = dsign(lanes) * torch.sign(torch.where(d == 0, 1, d))
    a = dabs(lanes)
    dm = torch.abs(torch.where(d == 0, 1, d))
    q = (to_float64(a) / dm.to(torch.float64)).to(torch.int64)
    q = torch.clamp(q, min=0)
    for _ in range(2):
        r = dsub(a, dmul_int64(from_int64(q), dm))
        adj = torch.floor(to_float64(r) / dm.to(torch.float64)).to(torch.int64)
        q = q + adj
    rem = to_int64(dsub(a, dmul_int64(from_int64(q), dm)))
    fix_dn = rem < 0
    q = q - fix_dn.to(torch.int64)
    rem = rem + torch.where(fix_dn, dm, 0)
    fix_up = rem >= dm
    q = q + fix_up.to(torch.int64)
    rem = rem - torch.where(fix_up, dm, 0)
    q = q + (2 * rem >= dm).to(torch.int64)  # HALF_UP on the magnitude
    return sign * q


def segment_sum_wide(x_lanes, segment_ids, num_segments):
    """Exact segmented sum of lane pairs: per-lane segment sum, then one
    normalization. Safe for < 2^31 contributing rows per call."""
    sums = torch.zeros(
        (num_segments,) + tuple(x_lanes.shape[1:]), dtype=x_lanes.dtype,
        device=x_lanes.device,
    ).index_add_(0, segment_ids.to(torch.int64), x_lanes)
    hi, lo = dnorm(sums[..., 0], sums[..., 1])
    return torch.stack([hi, lo], dim=-1)


def cumsum_wide(x_lanes):
    """Exact prefix sums of lane pairs (same < 2^31 row bound)."""
    hi, lo = dnorm(torch.cumsum(x_lanes[..., 0], 0), torch.cumsum(x_lanes[..., 1], 0))
    return torch.stack([hi, lo], dim=-1)


def to_float64(lanes):
    return lanes[..., 0].to(torch.float64) * float(2**32) + lanes[..., 1].to(
        torch.float64
    )
