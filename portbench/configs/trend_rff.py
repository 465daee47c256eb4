"""``trend_rff``: ``y ~| SqExp(:x) + OU(:t) + Noise``, the north star's
formula (a continuous covariate and a time trend), on the random-Fourier-
feature path: its data, made from the seed, and its plain reference log
density.

Data, in O(n): t uniform on [0, ``time_span``], x standard normal times
``x_scale``; y = f_x(x) + f_t(t) + e, each f one draw of a Gaussian process
with its leaf's kernel at the lengthscale ``truth`` states, approximated by
``data_features`` random cosines of its own (not the model's features:
normal frequencies for SqExp, Cauchy for OU), and
e ~ N(0, noise_s2 + jitter + obs_sigma2).

Reference: the feature-space marginal log density that ``--approx rff``
defines, over the sampler's u (C, 2) (one lengthscale per ``--infer``
variable, in that order), plus the prior of u.  The features are
sqrt(2/m) cos(v w0 / l + b0), one block of ``rff_features`` a leaf in the
formula's order; w0 and b0 are drawn again here from numpy's
``default_rng(rff_seed)``, leaf by leaf (w0 from the kernel's spectral
density at unit lengthscale: standard normal for SqExp, standard Cauchy for
OU; then b0 uniform on [0, 2 pi)), the order that defines the model's map,
and rounded to the working dtype as the model's constants are.  The marginal
is N(y; 0, Phi Phi^T + d I), d = noise_s2 + jitter + obs_sigma2, by the
Woodbury identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import reference as ref

#: the formula's stationary leaves, in its order: (column, kernel)
LEAVES = (("x", "SqExp"), ("t", "OU"))


def make_data(cfg: dict, gen: torch.Generator, device) -> dict:
    """Columns and response, float64, from ``gen``."""
    n, F = cfg["n"], cfg["data_features"]
    f64 = dict(dtype=torch.float64, device=device)
    cols = {"t": torch.rand((n,), generator=gen, **f64) * cfg["time_span"],
            "x": torch.randn((n,), generator=gen, **f64) * cfg["x_scale"]}
    y = torch.zeros((n,), **f64)
    for v, kind in LEAVES:
        w0 = torch.empty((F,), **f64)
        w0 = w0.normal_(generator=gen) if kind == "SqExp" else w0.cauchy_(generator=gen)
        w = w0 / cfg["truth"][v]
        b = torch.rand((F,), generator=gen, **f64) * (2.0 * math.pi)
        a = torch.randn((F,), generator=gen, **f64)
        y += math.sqrt(2.0 / F) * (torch.cos(cols[v][:, None] * w + b) @ a)
    d = cfg["noise_s2"] + cfg["jitter"] + cfg["obs_sigma2"]
    y += math.sqrt(d) * torch.randn((n,), generator=gen, **f64)
    return {"columns": cols, "y": y}


def frequencies(cfg: dict):
    """Per leaf, (w0, b0) as float64 numpy arrays, in the map's order."""
    rng = np.random.default_rng(cfg["rff_seed"])
    m = cfg["rff_features"]
    out = []
    for _, kind in LEAVES:
        w0 = rng.standard_normal(m) if kind == "SqExp" else rng.standard_cauchy(m)
        b0 = rng.uniform(0.0, 2.0 * np.pi, m)
        out.append((w0, b0))
    return out


def logdensity(cfg: dict, columns: dict, y: torch.Tensor, ar: ref.Arith):
    """u (C, 2) -> (C,) in ``ar``'s arithmetic; the inputs and the
    frequencies are cast to its dtype from their values in the
    configuration's precision."""
    device = y.device
    m = cfg["rff_features"]
    stored = {"float32": torch.float32, "float64": torch.float64}[cfg["precision"]]
    const = lambda a: torch.as_tensor(a, dtype=stored, device=device).to(ar.dtype)
    freq = [(const(w0), const(b0)) for w0, b0 in frequencies(cfg)]
    cols = [columns[v].to(ar.dtype) for v, _ in LEAVES]
    slot = [cfg["infer"].index(v) for v, _ in LEAVES]
    y = y.to(ar.dtype)
    d = cfg["noise_s2"] + cfg["jitter"] + cfg["obs_sigma2"]
    scale = math.sqrt(2.0 / m)
    prior = ref.parse_uniform(cfg["prior"])

    def lp(u: torch.Tensor) -> torch.Tensor:
        ls = prior.x(u)                                          # (C, 2)
        phi = torch.cat([scale * torch.cos(c[:, None] * (w0 / ls[:, i, None])[:, None, :] + b0)
                         for i, c, (w0, b0) in zip(slot, cols, freq)], dim=-1)
        return ref.lowrank_gaussian_lp(phi, d, y, ar) + prior.log_density_u(u)

    return lp
