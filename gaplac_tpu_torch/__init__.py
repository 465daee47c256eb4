"""gaplac_tpu_torch — the PyTorch/CUDA port of ``gaplac_tpu``.

The package mirrors ``gaplac_tpu``'s module paths so each counterpart is
easy to find, and is held against it by the ``tests/test_torch_*.py``
parity tests.  It imports ``torch``, never ``jax`` and nothing of
``gaplac_tpu``: the formula DSL (``dsl/``) and the table I/O (``data/``)
are its own copies.

On a CUDA device the dense hot path (gram, its backward, the batched
Cholesky, the base tile of the blocked Cholesky) runs through the hand-written kernels in ``csrc/``; on the CPU
the same wrappers run their plain PyTorch versions.  The low-rank ``--approx
rff`` path (``kernels/features.py``, ``ops/lowrank.py``) factors its
capacitance matrices through the same Cholesky kernels.  ``ops/fused.py``
factors a dense gram left-looking, panel by panel, without materializing
it (K2 at global row offsets, K3 for the tiles, K2b for the backward).
``parallel/`` starts a multi-process run from the ``GAPLAC_*`` variables on
``torch.distributed`` (NCCL on the cards, gloo on the CPU) and shards the
NUTS chains, the ChEES/HMC adaptation and the dense and low-rank log
densities' rows over its ranks.
"""

__version__ = "0.1.0"

from gaplac_tpu_torch.dsl.parser import Spec, parse_formula  # noqa: E402

__all__ = ["parse_formula", "Spec", "__version__"]
