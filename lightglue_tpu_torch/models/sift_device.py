"""SIFT on the device: the Gaussian scale space, DoG detection and
descriptors in PyTorch (counterpart of lightglue_tpu/models/sift_jax.py).

Lowe (IJCV 2004) with OpenCV's constants, as the JAX package computes it:

* scale space: ``num_scales_per_octave`` layers an octave, sigma0 1.6, the
  image doubled first (first_octave -1, assumed blur 0.5), separable
  Gaussian blurs as tap-weighted shifted sums with reflect-101 borders,
  OpenCV's octave count;
* detection: 26-neighbour extrema of the DoG stack above a prefilter
  threshold, an octave's strongest candidates, five Newton steps of
  sub-pixel refinement on 3x3x3 cubes (Cramer's solve), then the contrast
  and edge tests;
* orientation: 36-bin Gaussian-weighted gradient histograms over a fixed
  33 x 33 window (masked to each point's radius), smoothed twice, the
  dominant peak and the peaks above 0.8 of it (up to ``MAX_ORI``);
* descriptor: 4 x 4 x 8 trilinear histograms over a rotated 16 x 16
  sample grid, clipped at 0.2, renormalized and scaled to 512 (OpenCV).

Static shapes throughout: each octave keeps a fixed budget of candidates
and instances, invalid slots carry validity masks. Every top-k is exact,
ties to the lower index (a stable sort). The JAX package's arithmetic is
kept where it decides: XLA on the CPU contracts a product and a sum into
one fused multiply-add (the Newton step, the gradient magnitude), and
``fma`` reproduces each. On a CUDA tensor the blur is one fp32 convolution
an axis; on the CPU it is XLA's chain of fused multiply-adds over the taps
(``_blur_fma``), so that the pyramid, the candidates and the refinement
there agree with the JAX package's to the bit (the two forms differ by an
ulp or so, ``tests/test_torch_sift.py`` holds them together). The
transcendental functions (exp, atan2, sin, cos, pow) and long sums (the
histograms, the descriptor product) are PyTorch's and agree to a few ulp.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import SIFTConfig
from ..nn import fp32_convs, upsample2

SIGMA0 = 1.6
INIT_BLUR = 0.5
MAX_ORI = 4  # keypoints repeated for up to this many orientation peaks
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS_FCTR = 3.0 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
ORI_MAX_RADIUS = 16
DESC_WIDTH = 4
DESC_BINS = 8
DESC_SCL_FCTR = 3.0
DESC_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
BORDER = 5  # OpenCV's SIFT_IMG_BORDER
MAX_INTERP_STEPS = 5


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to fp32 (a fused multiply-add), through
    float64: the product is exact there, and the sum rounds to fp32 as
    the fused operation does (but for a double rounding, which needs the
    two terms 2^29 apart and the sum on an fp32 midpoint)."""
    t = torch.as_tensor
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    return (t(a, device=dev).double() * t(b, device=dev).double()
            + t(c, device=dev).double()).float()


def gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(round(sigma * 4)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of n padded by r on each side with reflect-101
    (numpy's "reflect"; a pad longer than the axis reflects again, as in
    the late octaves' few rows)."""
    i = torch.arange(-r, n + r, device=device)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


def _blur_fma_axis(img: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    r = (len(k) - 1) // 2
    n = img.shape[dim]
    x = img.index_select(dim, reflect_index(n, r, img.device))
    x64 = x.double()
    # XLA's sum of the tap products: the first two as one fused
    # multiply-add, then each further tap fused into the running sum; in
    # float64 each product is exact, so one rounding to fp32 a step is the
    # fused operation's
    acc = torch.add((float(k[1]) * x.narrow(dim, 1, n)).double(),
                    x64.narrow(dim, 0, n), alpha=float(k[0])).float()
    for t in range(2, len(k)):
        acc = torch.add(acc.double(), x64.narrow(dim, t, n),
                        alpha=float(k[t])).float()
    return acc


def _blur_fma(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """The blur as XLA on the CPU sums it (the JAX package's arithmetic)."""
    return _blur_fma_axis(_blur_fma_axis(img, k, 0), k, 1)


def _blur_conv(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """The blur as two fp32 convolutions (TF32 off) of the reflect-101
    padded plane, rows then columns."""
    r = (len(k) - 1) // 2
    h, w = img.shape
    x = img.index_select(0, reflect_index(h, r, img.device)).index_select(
        1, reflect_index(w, r, img.device))
    taps = torch.from_numpy(k).to(img.device)
    with fp32_convs():
        x = F.conv2d(x[None, None], taps.view(1, 1, -1, 1))
        x = F.conv2d(x, taps.view(1, 1, 1, -1))
    return x[0, 0]


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian on (H, W), rows then columns, with reflect-101
    borders (OpenCV's default; border values compound through the s + 3
    blurs of an octave): convolutions on a CUDA tensor, XLA's tap chain on
    the CPU."""
    if sigma <= 0:
        return img
    k = gaussian_kernel(sigma)
    return _blur_conv(img, k) if img.is_cuda else _blur_fma(img, k)


def layer_sigmas(s: int) -> List[float]:
    """The incremental blur of each layer of an octave (OpenCV's
    buildGaussianPyramid)."""
    k = 2.0 ** (1.0 / s)
    sig = [SIGMA0]
    for i in range(1, s + 3):
        sig_prev = SIGMA0 * (k ** (i - 1))
        sig.append(math.sqrt((sig_prev * k) ** 2 - sig_prev ** 2))
    return sig


def build_pyramid(
    image: torch.Tensor, conf: SIFTConfig
) -> Tuple[List[List[torch.Tensor]], List[List[torch.Tensor]], int]:
    """(gaussians[octave][layer], dogs[octave][layer], number of octaves)
    of an (H, W) image in [0, 1], scaled by 255 to OpenCV's magnitudes."""
    img = image.float() * 255.0
    s = conf.num_scales_per_octave
    if conf.first_octave == -1:
        img = upsample2(img)
        base_blur = INIT_BLUR * 2
    else:
        base_blur = INIT_BLUR
    img = gaussian_blur(img, math.sqrt(max(SIGMA0 ** 2 - base_blur ** 2, 0.01)))
    h, w = img.shape
    n_octaves = max(1, int(round(math.log2(min(h, w)))) - 2)  # OpenCV
    sig = layer_sigmas(s)
    gaussians, dogs = [], []
    for _ in range(n_octaves):
        octave = [img]
        for i in range(1, s + 3):
            octave.append(gaussian_blur(octave[-1], sig[i]))
        gaussians.append(octave)
        dogs.append([octave[i + 1] - octave[i] for i in range(s + 2)])
        img = octave[s][::2, ::2]  # layer s has twice the base blur
    return gaussians, dogs, n_octaves


def pool3(x: torch.Tensor, op) -> torch.Tensor:
    """Separable 3x3x3 reduce of an (L, H, W) volume with edge padding."""
    for dim in range(3):
        n = x.shape[dim]
        p = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)
        x = op(op(p.narrow(dim, 0, n), p.narrow(dim, 1, n)), p.narrow(dim, 2, n))
    return x


def stable_topk(x: torch.Tensor, k: int):
    """The k largest entries along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def extrema_candidates(dog_stack: torch.Tensor, n_cand: int, thr: float):
    """26-neighbour extrema of layers 1 .. L-2 of dog_stack (L, H, W) whose
    |DoG| exceeds thr (maxima positive, minima negative, OpenCV's rule),
    away from the border; the n_cand strongest by |DoG|. Returns (layer,
    y, x) int64 and valid, each (n_cand,)."""
    l, h, w = dog_stack.shape
    center = dog_stack[1:-1]
    is_max = center == pool3(dog_stack, torch.maximum)[1:-1]
    is_min = center == pool3(dog_stack, torch.minimum)[1:-1]
    cand = (((is_max & (center > 0)) | (is_min & (center < 0)))
            & (center.abs() > thr))
    dev = dog_stack.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    cand &= ((ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER)
             & (xs < w - BORDER))
    flat = torch.where(cand, center.abs(), torch.zeros_like(center)).reshape(-1)
    k_eff = min(n_cand, flat.shape[0])  # small late octaves
    vals, idx = stable_topk(flat, k_eff)
    if k_eff < n_cand:
        vals = F.pad(vals, (0, n_cand - k_eff))
        idx = F.pad(idx, (0, n_cand - k_eff))
    li = idx // (h * w) + 1
    rem = idx % (h * w)
    return li, rem // w, rem % w, vals > 0


def _cube(dog_stack: torch.Tensor, li, yi, xi) -> torch.Tensor:
    """The 3x3x3 neighbourhood of each point, (N, 27) in (dl, dy, dx)
    row-major order; a start that would leave the volume is clamped, as
    ``jax.lax.dynamic_slice`` clamps it (only dead slots reach there)."""
    l, h, w = dog_stack.shape
    l0 = (li - 1).clamp(0, l - 3)
    y0 = (yi - 1).clamp(0, h - 3)
    x0 = (xi - 1).clamp(0, w - 3)
    d = torch.arange(3, device=dog_stack.device)
    offs = ((d[:, None, None] * h + d[None, :, None]) * w
            + d[None, None, :]).reshape(-1)
    base = (l0 * h + y0) * w + x0
    return dog_stack.reshape(-1)[base[:, None] + offs]


def _at(cube: torch.Tensor, dl: int, dy: int, dx: int) -> torch.Tensor:
    return cube[:, (dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)]


def _hessian_xy(cube: torch.Tensor, d: torch.Tensor):
    dxx = _at(cube, 0, 0, 1) + _at(cube, 0, 0, -1) - 2 * d
    dyy = _at(cube, 0, 1, 0) + _at(cube, 0, -1, 0) - 2 * d
    dxy = (_at(cube, 0, 1, 1) - _at(cube, 0, 1, -1) - _at(cube, 0, -1, 1)
           + _at(cube, 0, -1, -1)) * 0.25
    return dxx, dyy, dxy


def _newton_step(cube: torch.Tensor):
    """One quadratic fit on the cube: (offset (N, 3) as (x, y, layer),
    centre value, gradient (N, 3)); the offset 0 where the Hessian is
    singular. The symmetric 3x3 solve by its adjugate, each a * b - c * d
    as XLA fuses it: fma(a, b, -(c d))."""
    d = _at(cube, 0, 0, 0)
    dx1 = (_at(cube, 0, 0, 1) - _at(cube, 0, 0, -1)) * 0.5
    dy1 = (_at(cube, 0, 1, 0) - _at(cube, 0, -1, 0)) * 0.5
    ds1 = (_at(cube, 1, 0, 0) - _at(cube, -1, 0, 0)) * 0.5
    dxx, dyy, dxy = _hessian_xy(cube, d)
    dss = _at(cube, 1, 0, 0) + _at(cube, -1, 0, 0) - 2 * d
    dxs = (_at(cube, 1, 0, 1) - _at(cube, 1, 0, -1) - _at(cube, -1, 0, 1)
           + _at(cube, -1, 0, -1)) * 0.25
    dys = (_at(cube, 1, 1, 0) - _at(cube, 1, -1, 0) - _at(cube, -1, 1, 0)
           + _at(cube, -1, -1, 0)) * 0.25
    g = torch.stack([dx1, dy1, ds1], -1)
    a00 = fma(dyy, dss, -(dys * dys))
    a01 = fma(dys, dxs, -(dxy * dss))
    a02 = fma(dxy, dys, -(dxs * dyy))
    a11 = fma(dxx, dss, -(dxs * dxs))
    a12 = fma(dxy, dxs, -(dxx * dys))
    a22 = fma(dxx, dyy, -(dxy * dxy))

    det = fma(dxs, a02, fma(dxx, a00, dxy * a01))
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    sx = fma(a02, ds1, fma(a00, dx1, a01 * dy1))
    sy = fma(a12, ds1, fma(a01, dx1, a11 * dy1))
    ss = fma(a22, ds1, fma(a02, dx1, a12 * dy1))
    off = -torch.stack([sx, sy, ss], -1) * inv_det[:, None]
    return torch.where(ok[:, None], off, torch.zeros_like(off)), d, g


def refine(dog_stack: torch.Tensor, li, yi, xi, valid, conf: SIFTConfig):
    """Quadratic sub-pixel refinement with re-centring (OpenCV's
    adjustLocalExtrema): up to five Newton steps; a point converges when
    every |offset| < 0.5, and is dropped if it is still moving after five
    steps or steps outside the border; then the contrast test and the edge
    test on the 2x2 spatial Hessian. Returns (layer, y, x) fp32, |response|
    and valid."""
    l, h, w = dog_stack.shape
    s = conf.num_scales_per_octave
    n = li.shape[0]
    dev = dog_stack.device
    converged = torch.zeros(n, dtype=torch.bool, device=dev)
    alive = valid
    off_final = torch.zeros(n, 3, device=dev)
    d_final = torch.zeros(n, device=dev)
    g_final = torch.zeros(n, 3, device=dev)
    for _ in range(MAX_INTERP_STEPS):
        off, d, g = _newton_step(_cube(dog_stack, li, yi, xi))
        done_now = (off.abs() < 0.5).all(-1)
        newly = done_now & ~converged
        off_final = torch.where(newly[:, None], off, off_final)
        d_final = torch.where(newly, d, d_final)
        g_final = torch.where(newly[:, None], g, g_final)
        converged |= done_now
        moving = alive & ~converged
        step = torch.round(off).long()  # half to even, as jnp.round
        zero = torch.zeros_like(li)
        xi_n = xi + torch.where(moving, step[:, 0], zero)
        yi_n = yi + torch.where(moving, step[:, 1], zero)
        li_n = li + torch.where(moving, step[:, 2], zero)
        out = ((li_n < 1) | (li_n > l - 2) | (xi_n < BORDER)
               | (xi_n >= w - BORDER) | (yi_n < BORDER) | (yi_n >= h - BORDER))
        alive = alive & ~(out & moving)
        xi = xi_n.clamp(1, w - 2)
        yi = yi_n.clamp(1, h - 2)
        li = li_n.clamp(1, l - 2)
    # the reduce over the three products: a chain of fused multiply-adds
    acc = g_final[:, 0] * off_final[:, 0]
    acc = fma(g_final[:, 1], off_final[:, 1], acc)
    acc = fma(g_final[:, 2], off_final[:, 2], acc)
    contr = d_final + 0.5 * acc
    valid = alive & converged
    valid = valid & (contr.abs() * s >= conf.detection_threshold * 255.0)
    # the edge test at the final positions, with the last step's centre
    dxx, dyy, dxy = _hessian_xy(_cube(dog_stack, li, yi, xi), d)
    tr = dxx + dyy
    det2 = fma(dxx, dyy, -(dxy * dxy))
    e = conf.edge_threshold
    valid = valid & (det2 > 0) & (tr * tr * e < (e + 1) ** 2 * det2)
    fx = xi.float() + off_final[:, 0]
    fy = yi.float() + off_final[:, 1]
    fl = li.float() + off_final[:, 2]
    return fl, fy, fx, contr.abs(), valid


def gradients(g: torch.Tensor):
    """Central differences (dx, dy) of (..., H, W), zero on the border
    rows and columns."""
    dx = torch.zeros_like(g)
    dx[..., :, 1:-1] = (g[..., :, 2:] - g[..., :, :-2]) * 0.5
    dy = torch.zeros_like(g)
    dy[..., 1:-1, :] = (g[..., 2:, :] - g[..., :-2, :]) * 0.5
    return dx, dy


def mag_ori(dx: torch.Tensor, dy: torch.Tensor):
    """Gradient magnitude (sqrt of fma(dx, dx, dy dy)) and orientation in
    [-pi, pi]; atan2(0, 0) = 0."""
    return torch.sqrt(fma(dx, dx, dy * dy)), torch.atan2(dy, dx)


def orientation_hist(dxs: torch.Tensor, dys: torch.Tensor, li, fy, fx,
                     sigma_rel, max_radius: int = ORI_MAX_RADIUS):
    """The 36-bin orientation histogram of each point (N, 36), smoothed
    twice with [1, 4, 6, 4, 1] / 16 (OpenCV's calcOrientationHist): a fixed
    (2R + 1)^2 window of its layer's gradients, Gaussian-weighted, masked
    to its radius. dxs, dys: (L, H, W); li selects each point's layer."""
    l, h, w = dxs.shape
    n = fy.shape[0]
    r = max_radius
    side = 2 * r + 1
    dev = dxs.device
    ar = torch.arange(-r, r + 1, device=dev)
    dyy = ar.repeat_interleave(side)[None, :]
    dxx = ar.repeat(side)[None, :]
    cy = torch.round(fy).long()
    cx = torch.round(fx).long()
    inside = ((cy[:, None] + dyy >= 1) & (cy[:, None] + dyy < h - 1)
              & (cx[:, None] + dxx >= 1) & (cx[:, None] + dxx < w - 1))
    # the window's rows of the zero-padded maps, its corner clamped into
    # them as jax.lax.dynamic_slice clamps it
    hp, wp = h + 2 * r, w + 2 * r
    pad = F.pad(torch.stack([dxs, dys]), (r, r, r, r))  # (2, L, Hp, Wp)
    y0 = cy.clamp(0, hp - side)
    x0 = cx.clamp(0, wp - side)
    base = (li.clamp(0, l - 1) * hp + y0) * wp + x0
    idx = base[:, None] + (dyy + r) * wp + (dxx + r)
    flat = pad.reshape(2, -1)
    m, o = mag_ori(flat[0][idx], flat[1][idx])
    radius = torch.round(ORI_RADIUS_FCTR * sigma_rel).long()[:, None]
    sig = (ORI_SIG_FCTR * sigma_rel)[:, None]
    dist2 = (dyy ** 2 + dxx ** 2).float()
    wgt = torch.exp(-dist2 / (2 * (sig * sig)))
    keep = inside & (dyy.abs() <= radius) & (dxx.abs() <= radius)
    m = torch.where(keep, m * wgt, torch.zeros_like(m))
    bins = torch.remainder(torch.round(o * (ORI_HIST_BINS / (2 * math.pi))).long(),
                           ORI_HIST_BINS)
    zero = torch.zeros_like(m)
    hist = torch.stack([torch.where(bins == b, m, zero).sum(1)
                        for b in range(ORI_HIST_BINS)], 1)

    def smooth(hh):
        prev2, prev1 = torch.roll(hh, 2, -1), torch.roll(hh, 1, -1)
        next1, next2 = torch.roll(hh, -1, -1), torch.roll(hh, -2, -1)
        return fma(hh, 6 / 16, fma(prev1 + next1, 4 / 16,
                                   (prev2 + next2) * (1 / 16)))

    return smooth(smooth(hist))


def hist_peaks(hist: torch.Tensor):
    """The dominant and secondary peaks (>= 0.8 of the largest) of each
    histogram, parabola-interpolated: (angles (N, MAX_ORI) radians, valid
    (N, MAX_ORI))."""
    nb = ORI_HIST_BINS
    prev = torch.roll(hist, 1, -1)
    nxt = torch.roll(hist, -1, -1)
    is_peak = (hist > prev) & (hist > nxt)
    mx = hist.max(-1, keepdim=True).values
    order = torch.where(is_peak, hist, torch.full_like(hist, -math.inf))
    vals, idx = stable_topk(order, MAX_ORI)
    ok = (vals >= ORI_PEAK_RATIO * mx) & torch.isfinite(vals)
    lv = torch.gather(prev, -1, idx)
    rv = torch.gather(nxt, -1, idx)
    denom = lv - 2 * vals + rv
    shift = torch.where(denom.abs() > 1e-12, 0.5 * (lv - rv) / denom,
                        torch.zeros_like(denom))
    bin_f = torch.remainder(idx.float() + shift, float(nb))
    return bin_f * (2 * math.pi / nb), ok


def descriptors(dxs: torch.Tensor, dys: torch.Tensor, li, fy, fx, sigma_rel,
                angles) -> torch.Tensor:
    """4 x 4 x 8 SIFT descriptors (N, 128) at the given points and
    orientations, in OpenCV's 512-scaled form: a rotated 16 x 16 sample
    grid, Gaussian-weighted magnitudes spread over the cells and
    orientation bins by triangular weights (one product a point), clipped
    at 0.2 of the norm and renormalized."""
    l, h, w = dxs.shape
    d, nb = DESC_WIDTH, DESC_BINS
    dev = dxs.device
    hist_width = DESC_SCL_FCTR * sigma_rel
    su = (torch.arange(-8, 8, device=dev, dtype=torch.float32) + 0.5) / 4.0
    u = su.repeat(16)  # columns: x
    v = su.repeat_interleave(16)  # rows: y
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    dx_img = fma(u[None], cos, -(v[None] * sin)) * hist_width[:, None]
    dy_img = fma(u[None], sin, v[None] * cos) * hist_width[:, None]
    sx = fx[:, None] + dx_img
    sy = fy[:, None] + dy_img
    inside = (sx >= 1) & (sx < w - 2) & (sy >= 1) & (sy < h - 2)
    xi = torch.round(sx).clamp(1, w - 2).long()
    yi = torch.round(sy).clamp(1, h - 2).long()
    idx = (li[:, None] * h + yi) * w + xi
    m, o = mag_ori(dxs.reshape(-1)[idx], dys.reshape(-1)[idx])
    wgt = torch.exp(-fma(u, u, v * v) / (0.5 * d) ** 2 / 2)
    m = torch.where(inside, m * wgt, torch.zeros_like(m))
    # the angle relative to the point's (y-down orientations: angle - o)
    obin = torch.remainder((angles[:, None] - o) * (nb / (2 * math.pi)),
                           float(nb))
    ub = (u + d / 2 - 0.5)[None].expand_as(m)
    vb = (v + d / 2 - 0.5)[None].expand_as(m)
    cu = torch.arange(d, device=dev, dtype=torch.float32)
    au = torch.clamp(1.0 - (ub[..., None] - cu).abs(), min=0.0)  # (n, S, d)
    av = torch.clamp(1.0 - (vb[..., None] - cu).abs(), min=0.0)
    co = torch.arange(nb, device=dev, dtype=torch.float32)
    od = (obin[..., None] - co).abs()
    ao = torch.clamp(1.0 - torch.minimum(od, nb - od), min=0.0)  # (n, S, nb)
    vo = (av[..., :, None] * ao[..., None, :]).reshape(*m.shape, d * nb)
    desc = torch.bmm((m[..., None] * au).transpose(1, 2), vo)  # (n, u, v o)
    desc = desc.reshape(-1, d, d, nb).transpose(1, 2).reshape(-1, d * d * nb)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = torch.minimum(desc, DESC_MAG_THR * norm.clamp(min=1e-12))
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / norm.clamp(min=1e-12) * INT_DESCR_FCTR
    return desc.clamp(max=255.0)


def _keep(d: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in d.items()}


def extract_single(image: torch.Tensor, conf: SIFTConfig) -> dict:
    """SIFT of one (H, W) image in [0, 1]. Returns static-size tensors:
    keypoints (K, 2) at the input's scale, scales (K) (OpenCV's size),
    oris (K) in [0, 2 pi), keypoint_scores (K), descriptors (K, 128),
    valid (K); K = max_num_keypoints."""
    s = conf.num_scales_per_octave
    k_total = conf.max_num_keypoints
    gaussians, dogs, n_oct = build_pyramid(image, conf)
    # OpenCV floors the prefilter threshold (sift.cpp: cvFloor(0.5 * ...))
    thr_pre = float(math.floor(0.5 * conf.detection_threshold / s * 255.0))
    per_octave = []
    for o in range(n_oct):
        # a generous candidate pool an octave: refinement and the tests
        # reject most raw extrema; octaves shrink 4x each
        n_cand = max(256, (4 * k_total) >> o)
        dog_stack = torch.stack(dogs[o])
        li, yi, xi, valid = extrema_candidates(dog_stack, n_cand, thr_pre)
        fl, fy, fx, resp, valid = refine(dog_stack, li, yi, xi, valid, conf)
        pts = dict(fl=fl, fy=fy, fx=fx, resp=resp, valid=valid)
        if n_cand > k_total:
            # the global top k_total is within each octave's top k_total
            _, keep = stable_topk(torch.where(valid, resp, -1.0), k_total)
            pts = _keep(pts, keep)
        sigma_rel = SIGMA0 * torch.pow(2.0, pts["fl"] / s)
        lg_idx = torch.round(pts["fl"]).long().clamp(0, s + 2)
        dxs, dys = gradients(torch.stack(gaussians[o]))
        hist = orientation_hist(dxs, dys, lg_idx, pts["fy"], pts["fx"],
                                sigma_rel)
        angles, aok = hist_peaks(hist)
        # one instance a (point, orientation peak), compacted to k_total
        # before the descriptors: the output keeps at most k_total
        rep = lambda v: v.repeat_interleave(MAX_ORI, 0)  # noqa: E731
        inst = dict(li=rep(lg_idx), fy=rep(pts["fy"]), fx=rep(pts["fx"]),
                    sig=rep(sigma_rel), ang=angles.reshape(-1),
                    resp=rep(pts["resp"]),
                    valid=(pts["valid"][:, None] & aok).reshape(-1))
        n_inst = min(pts["fy"].shape[0] * MAX_ORI, k_total)
        if inst["resp"].shape[0] > n_inst:
            _, keep = stable_topk(torch.where(inst["valid"], inst["resp"], -1.0),
                                  n_inst)
            inst = _keep(inst, keep)
        desc = descriptors(dxs, dys, inst["li"], inst["fy"], inst["fx"],
                           inst["sig"], inst["ang"])
        scale = 2.0 ** (o + conf.first_octave)
        per_octave.append(dict(
            x=inst["fx"] * scale, y=inst["fy"] * scale,
            size=inst["sig"] * scale * 2.0,  # OpenCV's size = 2 sigma
            resp=inst["resp"], ori=inst["ang"], valid=inst["valid"],
            desc=desc))
    allc = {k: torch.cat([p[k] for p in per_octave]) for k in per_octave[0]}
    top, sel = stable_topk(torch.where(allc["valid"], allc["resp"], -1.0),
                           k_total)
    out_valid = top > 0
    return {
        "keypoints": torch.stack([allc["x"][sel], allc["y"][sel]], -1),
        "scales": allc["size"][sel],
        "oris": torch.remainder(allc["ori"][sel], 2 * math.pi),
        "keypoint_scores": torch.where(out_valid, top, torch.zeros_like(top)),
        "descriptors": torch.where(out_valid[:, None], allc["desc"][sel],
                                   torch.zeros_like(allc["desc"][sel])),
        "valid": out_valid,
    }


def extract_batch(images: torch.Tensor, conf: SIFTConfig) -> dict:
    """``extract_single`` over (B, H, W) images, one after another,
    stacked."""
    outs = [extract_single(im, conf) for im in images]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def rootsift(desc: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L1-normalize, square root, L2-normalize (reference sift.py:53-56)."""
    x = desc / desc.abs().sum(-1, keepdim=True).clamp(min=eps)
    x = torch.sqrt(x.clamp(min=0.0))
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def to_gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W), (B, H, W, 1) or RGB (B, H, W, 3) -> (B, H, W) fp32, RGB
    by the reference's grey weights as XLA computes the JAX package's
    product with them: a chain of fused multiply-adds."""
    images = images.float()
    if images.dim() == 3:
        return images
    if images.shape[-1] != 3:
        return images[..., 0]
    r, g, b = images.unbind(-1)
    c = [float(np.float32(v)) for v in (0.299, 0.587, 0.114)]
    return fma(b, c[2], fma(g, c[1], r * c[0]))


@torch.inference_mode()
def forward(params, conf: SIFTConfig, images: torch.Tensor, sizes=None):
    """The extractors' forward surface, so that SIFT plugs into
    ``end_to_end``: ``params`` is unused (SIFT learns nothing), ``sizes``
    too. images: (B, H, W) or (B, H, W, C) in [0, 1] (RGB by the
    reference's grey weights). Returns Features with scales and oris and,
    with ``conf.rootsift``, RootSIFT descriptors."""
    from .superpoint import Features

    out = extract_batch(to_gray(images), conf)
    desc = out["descriptors"]
    if conf.rootsift:
        desc = torch.where(out["valid"][..., None], rootsift(desc),
                           torch.zeros_like(desc))
    return Features(
        keypoints=out["keypoints"],
        keypoint_scores=out["keypoint_scores"],
        descriptors=desc,
        valid=out["valid"],
        scales=out["scales"],
        oris=out["oris"],
    )
