"""The tolerance of the leaf-test probes: which rays' outputs may differ
between K7 and its plain version, or between either probe and the JAX
probe, because a float64 evaluation shows the deciding quantity too close
to call.

Each candidate triangle of a ray is decided by four quantities (a, u*a,
v*a, t*a).  Every quantity may move by `tol` times its scale, the sum of
the absolute terms that make it.  A ray is explained if that can flip an
acceptance or let another candidate reach the least t (`uncertain`), or if
every output is the float64 winner's within those moves (`explained`).
`disagreements` applies the rule to two outputs; `mxu_quantities` and
`vpu_quantities` give the quantities of K7's and K6's candidates.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.ops.leaf_probe import EPS, FAR, RECORD


def _interval_quotient(num, num_err, den, den_err):
    """Bounds of num / den for num and den anywhere in their intervals;
    (-inf, inf) where the denominator's interval holds 0."""
    lo_d, hi_d = den - den_err, den + den_err
    corners = torch.stack([(num - num_err) / lo_d, (num - num_err) / hi_d,
                           (num + num_err) / lo_d, (num + num_err) / hi_d])
    lo, hi = corners.amin(0), corners.amax(0)
    spans_zero = (lo_d <= 0) & (hi_d >= 0)
    inf = torch.full_like(lo, float("inf"))
    return torch.where(spans_zero, -inf, lo), torch.where(spans_zero, inf, hi)


def _intervals(quant, scale, tol: float) -> dict:
    """u, v, t (bounds and float64 values) and the sure and possible
    acceptances of every candidate when each of its four quantities
    (a, u*a, v*a, t*a) moves by up to `tol` times its scale."""
    a, ua, va, ta = quant
    ea, eu, ev, et = tol * scale
    iv = dict(u=_interval_quotient(ua, eu, a, ea), v=_interval_quotient(va, ev, a, ea),
              t=_interval_quotient(ta, et, a, ea), u64=ua / a, v64=va / a, t64=ta / a)
    (u_lo, u_hi), (v_lo, v_hi), (t_lo, t_hi) = iv["u"], iv["v"], iv["t"]
    eps = float(EPS)
    iv["sure"] = ((a.abs() - ea >= eps) & (u_lo >= 0) & (u_hi <= 1) & (v_lo >= 0)
                  & (u_hi + v_hi <= 1) & (t_lo > eps))
    iv["maybe"] = ((a.abs() + ea >= eps) & (u_hi >= 0) & (u_lo <= 1) & (v_hi >= 0)
                   & (u_lo + v_lo <= 1) & (t_hi > eps))
    return iv


def uncertain(quant, scale, tol: float) -> torch.Tensor:
    """Bool [R]: whether the closest hit of each ray can change when each of
    its candidates' four quantities (a, u*a, v*a, t*a) moves by up to `tol`
    times its scale (the sum of the absolute terms that make it).

    `quant`, `scale`: float64 [4, K, R].  The closest hit is the first
    candidate of least t among the accepted ones (the probes' sequential
    strict `tt < t`).  A ray is uncertain if a candidate's acceptance can
    go either way, or if another accepted candidate's t can reach the
    least t."""
    iv = _intervals(quant, scale, tol)
    sure, maybe = iv["sure"], iv["maybe"]
    t_lo, t_hi = iv["t"]
    inf = torch.full_like(t_hi, float("inf"))
    best_hi = torch.where(sure, t_hi, inf).amin(0)  # the winner's t is at most this
    contenders = (maybe & (t_lo <= best_hi)).sum(0)
    return (maybe & ~sure).any(0) | (contenders > 1)


def explained(outs: list, quant, scale, tol: float, with_uv: bool) -> torch.Tensor:
    """Bool [R]: rays whose outputs in `outs` (float [R] each) are all what
    the float64 evaluation allows: the closest hit is `uncertain`, or every
    output is the float64 winner's t (+ u + v `with_uv`) + slot within the
    bounds of those quantities under the same moves of `tol` times their
    scale (1e30 where nothing is hit).  A t that is a small difference of
    large terms moves far in relative terms while its hit is certain."""
    iv = _intervals(quant, scale, tol)
    sure = iv["sure"]
    r = sure.shape[1]
    cols = torch.arange(r)
    t_sure = torch.where(sure, iv["t64"], torch.full_like(iv["t64"], float("inf")))
    best, slot = t_sure.amin(0), t_sure.argmin(0)
    hit = torch.isfinite(best)
    want = best + slot.double()
    slack = 0.0
    for key in ("t", "u", "v") if with_uv else ("t",):
        lo, hi = (x[slot, cols] for x in iv[key])
        v64 = iv[f"{key}64"][slot, cols]
        slack = slack + torch.maximum(hi - v64, v64 - lo)
        if key != "t":
            want = want + v64
    slack = slack + 1e-6 * want.abs()  # float32 rounding of the sum
    ok = torch.ones(r, dtype=torch.bool)
    for out in outs:
        out = out.double().cpu()
        ok &= torch.where(hit, (out - want).abs() <= slack, out == float(FAR))
    return uncertain(quant, scale, tol) | ok


def disagreements(got, want, quantities, with_uv: bool, rtol: float = 1e-5,
                  tol: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(beyond, unexplained): the flat positions where two outputs of a
    leaf probe differ beyond `rtol`, and those among them that the float64
    evaluation does not explain (`explained`).  `quantities(positions)`
    gives (quantities, scales) [4, K, len(positions)] of those rays."""
    g, w = got.reshape(-1).double().cpu(), want.reshape(-1).double().cpu()
    beyond = torch.nonzero((g - w).abs() > rtol * w.abs()).squeeze(1)
    if beyond.numel() == 0:
        return beyond, beyond
    quant, scale = quantities(beyond)
    return beyond, beyond[~explained([g[beyond], w[beyond]], quant, scale, tol, with_uv)]


def mxu_quantities(c_tab, phi, m: int, rays: torch.Tensor):
    """(quantities, scales) float64 [4, 4m, len(rays)] of K7's unique
    candidates for the rays `rays` (flat indices into [T * 4096]): the
    product in float64 and the sums of its absolute terms.  Flush i tests
    group i % 4, so flushes 0-3 hold every candidate, in slot order."""
    c = c_tab.double().cpu()
    p = phi.double().cpu().permute(0, 2, 1).reshape(-1, 16)[rays.cpu()].T  # [16, R]
    quant = (c @ p).reshape(4, 4, m, -1).permute(1, 0, 2, 3).reshape(4, 4 * m, -1)
    scale = (c.abs() @ p.abs()).reshape(4, 4, m, -1).permute(1, 0, 2, 3).reshape(4, 4 * m, -1)
    return quant, scale


def vpu_quantities(tris, comps, rays: torch.Tensor):
    """(quantities, scales) float64 [4, 512, len(rays)] of K6's candidates
    (a, u*a, v*a, t*a of each triangle, in slot order) for the rays `rays`
    (flat indices into the ray components), with the sums of absolute terms
    of their expansions."""
    rec = tris.double().cpu().reshape(-1, RECORD)[:, :9]
    v0, e1, e2 = rec[:, 0:3, None], rec[:, 3:6, None], rec[:, 6:9, None]  # [K, 3, 1]
    o = torch.stack([x.double().cpu().reshape(-1)[rays.cpu()] for x in comps[:3]])[None]
    d = torch.stack([x.double().cpu().reshape(-1)[rays.cpu()] for x in comps[3:]])[None]
    s = o - v0  # [K, 3, R]
    s_abs = o.abs() + v0.abs()

    def cross(x, y):
        return torch.linalg.cross(x.expand_as(s), y.expand_as(s), dim=1)

    def cross_abs(x, y):
        x, y = x.expand_as(s).abs(), y.expand_as(s).abs()
        return torch.stack([x[:, 1] * y[:, 2] + x[:, 2] * y[:, 1],
                            x[:, 2] * y[:, 0] + x[:, 0] * y[:, 2],
                            x[:, 0] * y[:, 1] + x[:, 1] * y[:, 0]], dim=1)

    h, h_abs = cross(d, e2), cross_abs(d, e2)
    q, q_abs = cross(s, e1), cross_abs(s_abs, e1)
    quant = torch.stack([(e1 * h).sum(1), (s * h).sum(1), (d * q).sum(1), (e2 * q).sum(1)])
    scale = torch.stack([(e1.abs() * h_abs).sum(1), (s_abs * h_abs).sum(1),
                         (d.abs() * q_abs).sum(1), (e2.abs() * q_abs).sum(1)])
    return quant, scale
