"""Environment map: equirect lookup and luminance importance sampling.

Counterpart of ``buas_pathtracer_tpu/ops/envmap.py``.  The host builds two
tables over the sin-weighted texel luminance (``Scene.pack``): exact
per-texel marginal / conditional CDFs, and a Walker alias table with the
per-texel solid-angle pdf numerator.  The integrators sample through the
alias table (``sample_env_alias``, O(1) per ray) and weigh MIS with
``env_pdf_table``; the CDF sampler and its pdf (``sample_env_direction``,
``env_pdf``) stay as the oracle the alias sampler is tested against.
``lookup_env`` is the reference's skydome branch of sample_sky
(integrators.cpp:274-288) with its integer truncation and modulo.

Alias indices are int64 here (the JAX package stores them as exact float
values); the values are equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.vec import PI, TAU, Vec3


def build_env_cdf(env: np.ndarray):
    """Per-row marginal CDF over sin-weighted luminance and per-row
    conditional CDFs: (marginal (H+1,), conditional (H, W+1)) float32."""
    h, w, _ = env.shape
    luma = (0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2])
    theta = (np.arange(h) + 0.5) / h * np.pi
    weighted = np.maximum(luma, 0.0) * np.sin(theta)[:, None]
    row_sums = weighted.sum(axis=1)
    total = row_sums.sum()
    if total <= 0.0:
        marg = np.linspace(0.0, 1.0, h + 1, dtype=np.float32)
        cond = np.tile(np.linspace(0.0, 1.0, w + 1, dtype=np.float32), (h, 1))
        return marg, cond
    marg = np.zeros(h + 1, np.float32)
    marg[1:] = np.cumsum(row_sums / total)
    marg[-1] = 1.0
    cond = np.zeros((h, w + 1), np.float32)
    safe = np.where(row_sums > 0.0, row_sums, 1.0)
    cond[:, 1:] = np.cumsum(weighted / safe[:, None], axis=1)
    cond[:, -1] = 1.0
    return marg, cond


def build_env_alias(env: np.ndarray):
    """Walker alias table over the sin-weighted texel luminance.  Returns
    (prob_keep (K,) float32, alias (K,) int64, pdf_num (K,) float32), K =
    H*W, with pdf_solid_angle(d) = pdf_num[texel] / cos(latitude(d)), the
    value the CDF tables give (pm * pc / (2 pi^2 cos))."""
    h, w, _ = env.shape
    luma = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
            + 0.0722 * env[..., 2])
    theta = (np.arange(h) + 0.5) / h * np.pi
    weighted = (np.maximum(luma, 0.0) * np.sin(theta)[:, None]).reshape(-1)
    k = weighted.size
    total = weighted.sum()
    if total <= 0.0:
        p = np.full(k, 1.0 / k, np.float64)
    else:
        p = weighted.astype(np.float64) / total
    scaled = p * k
    prob = np.ones(k, np.float32)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    pdf_num = (p * k / (TAU * PI)).astype(np.float32)
    return prob, alias, pdf_num


def _hash01(x: torch.Tensor) -> torch.Tensor:
    """White-noise uniform in [0, 1) from the float bits of ``x``
    (intra-texel jitter only)."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64) & rng.M32
    b = rng.mul32(b ^ (b >> 16), 0x7FEB352D)
    b = rng.mul32(b ^ (b >> 15), 0x846CA68B)
    b = b ^ (b >> 16)
    return b.to(torch.float32) * (1.0 / 4294967296.0)


def _texel_direction(row, col, du_, dv_, h: int, w: int):
    vv = (row.to(torch.float32) + dv_) / h
    uu = (col.to(torch.float32) + du_) / w
    phi = (uu - 0.5) * TAU
    theta = (vv - 0.5) * PI
    cos_t = torch.cos(theta)
    d = Vec3(cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi))
    return d, cos_t


def sample_env_alias(prob, alias, pdf_num, env, u, v):
    """O(1) env importance sample: the CDF tables' texel distribution,
    hashed white noise inside the texel.  Returns (dir, pdf_sa, radiance)."""
    h, w, _ = env.shape
    k = h * w
    idx0 = torch.clamp((u * k).to(torch.int64), 0, k - 1)
    keep = v < prob[idx0]
    idx = torch.where(keep, idx0, alias[idx0])
    row = idx // w
    col = idx - row * w
    du_ = _hash01(u * 7193.17 + v)
    dv_ = _hash01(v * 4021.73 - u)
    d, cos_t = _texel_direction(row, col, du_, dv_, h, w)
    pdf = pdf_num[idx] / torch.clamp(cos_t, min=1e-8)
    flat = env.reshape(-1, 3)
    return d, pdf, Vec3(flat[idx, 0], flat[idx, 1], flat[idx, 2])


def _row_col(d: Vec3, h: int, w: int):
    phi = torch.atan2(d.z, d.x)
    theta = torch.asin(torch.clamp(d.y, -1.0, 1.0))
    u = 0.5 + 0.5 / PI * phi
    v = 0.5 + 1.0 / PI * theta
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    return row, col, theta


def env_pdf_table(pdf_num, h: int, w: int, d: Vec3):
    """Solid-angle pdf of direction ``d`` under the alias sampler."""
    row, col, theta = _row_col(d, h, w)
    return pdf_num[row * w + col] / torch.clamp(torch.cos(theta), min=1e-8)


def _searchsorted_cdf(cdf, u):
    """Index i with cdf[i] <= u < cdf[i+1]."""
    return torch.clamp(torch.searchsorted(cdf, u, right=True) - 1,
                       0, cdf.shape[0] - 2)


def _search_cond(cond, row, v):
    """Rightmost col of cond[row] with cond[row, col] <= v, by fixed-depth
    bisection over the flat table."""
    w1 = int(cond.shape[1])
    flat = cond.reshape(-1)
    base = row * w1
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w1 - 1)
    for _ in range(int(np.ceil(np.log2(max(w1, 2))))):
        mid = (lo + hi) // 2
        go = flat[base + mid] <= v
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid)
    col = torch.clamp(lo, 0, w1 - 2)
    return col, flat[base + col], flat[base + col + 1]


def sample_env_direction(marg, cond, env, u, v):
    """Inverse-CDF env sample.  Returns (dir, pdf_sa, radiance)."""
    h, w, _ = env.shape
    row = _searchsorted_cdf(marg, u)
    col, c_lo, c_hi = _search_cond(cond, row, v)
    m_lo = marg[row]
    m_hi = marg[row + 1]
    dv_ = (u - m_lo) / torch.clamp(m_hi - m_lo, min=1e-12)
    du_ = (v - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12)
    d, cos_t = _texel_direction(row, col, du_, dv_, h, w)
    pm = (m_hi - m_lo) * h
    pc = (c_hi - c_lo) * w
    pdf = (pm * pc) / torch.clamp(TAU * PI * cos_t, min=1e-8)
    flat = env.reshape(-1, 3)
    pix = row * w + col
    return d, pdf, Vec3(flat[pix, 0], flat[pix, 1], flat[pix, 2])


def lookup_env(env, d: Vec3) -> Vec3:
    """Equirect nearest lookup (integrators.cpp:274-288): truncation toward
    zero, then floor modulo."""
    h, w, _ = env.shape
    phi = torch.atan2(d.z, d.x)
    theta = torch.asin(torch.clamp(d.y, -1.0, 1.0))
    u = 0.5 + 0.5 / PI * phi
    v = 0.5 + 1.0 / PI * theta
    x = torch.remainder((u * w).to(torch.int64), w)
    y = torch.remainder((v * h).to(torch.int64), h)
    flat = env.reshape(-1, 3)
    pix = y * w + x
    return Vec3(flat[pix, 0], flat[pix, 1], flat[pix, 2])


def env_pdf(marg, cond, env, d: Vec3):
    """Solid-angle pdf of direction ``d`` under the CDF sampler."""
    h, w, _ = env.shape
    row, col, theta = _row_col(d, h, w)
    pm = (marg[row + 1] - marg[row]) * h
    flat = cond.reshape(-1)
    base = row * int(cond.shape[1])
    pc = (flat[base + col + 1] - flat[base + col]) * w
    return (pm * pc) / torch.clamp(TAU * PI * torch.cos(theta), min=1e-8)
