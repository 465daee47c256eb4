"""``longitudinal_dense``: GaPLAC's longitudinal formula
``y ~| OU(:t)*Cat(:PersonID) + Cat(:PersonID) + Noise`` on the dense exact
path: its data, made from the seed, and its plain reference log density.

Data: ``persons`` persons with ``visits`` visits each, at sorted uniform times
in [0, ``time_span``]; y is one draw of the model's own marginal at the
lengthscale ``truth.t``: y ~ N(0, K + (jitter + obs_sigma2) I) with
K = OU(t; l) * [same person] + [same person] + noise_s2 I.

Reference: the marginal log density of the same model over the sampler's
u (C, 1), l = lo + (hi - lo) sigmoid(u), plus the prior of u, from the
plain pieces of ``portbench/reference.py``.
"""

from __future__ import annotations

import torch

from portbench import reference as ref


def _cov(t: torch.Tensor, pid: torch.Tensor, ls: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(C, n, n) covariance of y at lengthscales ``ls`` (C,)."""
    same = (pid[:, None] == pid[None, :]).to(t.dtype)
    dist = torch.abs(t[:, None] - t[None, :])
    diag = cfg["noise_s2"] + cfg["jitter"] + cfg["obs_sigma2"]
    eye = torch.eye(t.shape[0], dtype=t.dtype, device=t.device)
    return torch.exp(-dist / ls[:, None, None]) * same + same + diag * eye


def make_data(cfg: dict, gen: torch.Generator, device) -> dict:
    """Columns and response, float64, from ``gen``."""
    P, V = cfg["persons"], cfg["visits"]
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.sort(torch.rand((P, V), generator=gen, **f64) * cfg["time_span"], dim=1).values
    t = t.reshape(-1)
    pid = torch.arange(P, **f64).repeat_interleave(V)
    K = _cov(t, pid, torch.tensor([cfg["truth"]["t"]], **f64), cfg)[0]
    z = torch.randn((P * V,), generator=gen, **f64)
    y = torch.linalg.cholesky(K) @ z
    return {"columns": {"t": t, "PersonID": pid}, "y": y}


def logdensity(cfg: dict, columns: dict, y: torch.Tensor, ar: ref.Arith):
    """u (C, 1) -> (C,) in ``ar``'s arithmetic; the inputs are cast to its
    dtype."""
    t, pid = (columns[k].to(ar.dtype) for k in ("t", "PersonID"))
    y = y.to(ar.dtype)
    prior = ref.parse_uniform(cfg["prior"])

    def lp(u: torch.Tensor) -> torch.Tensor:
        K = _cov(t, pid, prior.x(u)[:, 0], cfg)
        return ref.dense_gaussian_lp(K, y, ar) + prior.log_density_u(u)

    return lp
