"""``longitudinal_poisson``: counts on GaPLAC's longitudinal formula,
``y : Poisson ~| OU(:t)*Cat(:PersonID) + Cat(:PersonID) + Noise``, on the
whitened latent path (``mcmc``'s default ``--approx none`` for a count
likelihood): its data, made from the seed, and its plain reference log
density.

Data: ``persons`` persons with ``visits`` visits each, at sorted uniform times
in [0, ``time_span``]; f is one draw of the latent GP at the lengthscale
``truth.t``, f = L z* with L L^T = K + jitter I, K = OU(t; l) * [same person]
+ [same person] + noise_s2 I, in float64; y ~ Poisson(exp f).  The times and
the counts come from the seed; the whitened draw z* (n standard normals) comes
from ``truth.z_seed`` on the CPU, the same for every seed and device.  The
posterior over the sampler's z then lies about z* whatever the seed, so the
cell's adapted state (made on seed 0's data) starts every seed's chains near
their posterior, as the dense cell's lengthscale does.

Reference: the whitened log density over the sampler's v = [u, z] (C, 1 + n),
l = lo + (hi - lo) sigmoid(u), f = L z with L L^T = K(l) + jitter I:
prior(u) - z.z / 2 - n log(2 pi) / 2 + sum(y f - exp f - lgamma(y + 1)),
the factor by ``reference.cholesky``'s blocks and f = L z by ``ar.mm``.
"""

from __future__ import annotations

import torch

from portbench import reference as ref


def _cov(t: torch.Tensor, pid: torch.Tensor, ls: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(C, n, n) covariance of the latent f at lengthscales ``ls`` (C,)."""
    same = (pid[:, None] == pid[None, :]).to(t.dtype)
    dist = torch.abs(t[:, None] - t[None, :])
    eye = torch.eye(t.shape[0], dtype=t.dtype, device=t.device)
    return torch.exp(-dist / ls[:, None, None]) * same + same + (cfg["noise_s2"] + cfg["jitter"]) * eye


def make_data(cfg: dict, gen: torch.Generator, device) -> dict:
    """Columns and counts, float64, from ``gen``."""
    P, V = cfg["persons"], cfg["visits"]
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.sort(torch.rand((P, V), generator=gen, **f64) * cfg["time_span"], dim=1).values
    t = t.reshape(-1)
    pid = torch.arange(P, **f64).repeat_interleave(V)
    K = _cov(t, pid, torch.tensor([cfg["truth"]["t"]], **f64), cfg)[0]
    z = torch.randn((P * V,), generator=torch.Generator().manual_seed(cfg["truth"]["z_seed"]),
                    dtype=torch.float64).to(device)
    f = torch.linalg.cholesky(K) @ z
    y = torch.poisson(torch.exp(f), generator=gen)
    return {"columns": {"t": t, "PersonID": pid}, "y": y}


def logdensity(cfg: dict, columns: dict, y: torch.Tensor, ar: ref.Arith):
    """v (C, 1 + n) -> (C,) in ``ar``'s arithmetic; the inputs are cast to its
    dtype."""
    t, pid = (columns[k].to(ar.dtype) for k in ("t", "PersonID"))
    y = y.to(ar.dtype)
    n = y.shape[0]
    prior = ref.parse_uniform(cfg["prior"])
    const = -0.5 * n * ref.LOG_2PI - torch.lgamma(y + 1.0).sum()

    def lp(v: torch.Tensor) -> torch.Tensor:
        u, z = v[:, :1], v[:, 1:]
        L = ref.cholesky(_cov(t, pid, prior.x(u)[:, 0], cfg), ar)
        f = ar.mm(L, z[..., None])[..., 0]
        return (prior.log_density_u(u) - 0.5 * (z * z).sum(-1)
                + (y * f - torch.exp(f)).sum(-1) + const)

    return lp
