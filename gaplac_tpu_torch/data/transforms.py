"""Data transforms: ranks and the rank-based inverse-normal transform.
(The port's own copy of ``gaplac_tpu/data/transforms.py``.)

Reference parity: GaPLAC src/utils.jl:16-28 — ``getrank`` computes
1-based competition-free ranks via ``invperm(sortperm(v))`` (ties broken by
position, i.e. ordinal ranks with a stable sort), optionally flattening all
zeros to rank 1 (the "compositional data" normalizer for microbiome relative
abundances); ``invnormaltransform`` maps rank r to
``norminvcdf(mu, sigma, (r - c) / (n - 2c + 1))`` with the Blom offset
c = 3/8.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.special import ndtri


def getrank(v: Sequence[float], flattenzeros: bool = True) -> np.ndarray:
    """1-based ordinal ranks (stable; ties keep input order), with every exact
    zero flattened to rank 1 when ``flattenzeros`` (ref: utils.jl:16-23)."""
    v = np.asarray(v)
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), dtype=np.int64)
    ranks[order] = np.arange(1, len(v) + 1)
    if flattenzeros:
        ranks[v == 0] = 1
    return ranks


def invnormaltransform(
    v: Sequence[float],
    mu: float = 0.0,
    sigma: float = 1.0,
    c: float = 3.0 / 8.0,
    flattenzeros: bool = True,
) -> np.ndarray:
    """Rank-based inverse-normal (Blom) transform (ref: utils.jl:25-28)."""
    ranks = getrank(v, flattenzeros=flattenzeros).astype(float)
    n = len(ranks)
    q = (ranks - c) / (n - 2.0 * c + 1.0)
    return mu + sigma * ndtri(q)
