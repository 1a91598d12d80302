"""SMPLify-style GMM pose prior (max-mixture).

Port of `etch_tpu/fit/prior.py` (reference `src/utils/prior.py:100-230`,
MaxMixturePrior): the negative log-likelihood of a body pose under an
8-component Gaussian mixture fitted to mocap poses, approximated by its
best component.  `load_gmm_prior` reads the standard gmm_08.pkl;
`synthetic_gmm` is a stand-in where that file is absent (it is not in the
repository).  The reference does not wire the prior into its LM fit; the
port, like the JAX package, uses it in `fit/chamfer_refine.py` only.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch


class GMMPrior(NamedTuple):
    means: torch.Tensor        # (C, 69)
    precisions: torch.Tensor   # (C, 69, 69)
    log_norm: torch.Tensor     # (C,): log(weight_c / sqrt((2 pi)^D det(cov_c)))

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose (B, 69) -> (B,) negative log-likelihood (max-mixture)."""
        diff = pose[:, None, :] - self.means[None]                  # (B, C, D)
        mah = torch.einsum("bcd,cde,bce->bc", diff, self.precisions, diff)
        return -torch.max(self.log_norm[None] - 0.5 * mah, dim=1).values

    def to(self, device) -> "GMMPrior":
        return GMMPrior(*(t.to(device) for t in self))


def _prior(means, precisions, log_norm) -> GMMPrior:
    return GMMPrior(torch.from_numpy(np.ascontiguousarray(means)),
                    torch.from_numpy(np.ascontiguousarray(precisions)),
                    torch.from_numpy(np.ascontiguousarray(log_norm)))


def load_gmm_prior(path: str, dtype=np.float32) -> GMMPrior:
    """The mixture of a gmm_08.pkl (means, covars, weights), on the CPU."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    means = np.asarray(data["means"], dtype)
    covs = np.asarray(data["covars"], dtype)
    weights = np.asarray(data["weights"], dtype)
    precisions = np.stack([np.linalg.inv(c) for c in covs]).astype(dtype)
    D = means.shape[1]
    _, logdets = np.linalg.slogdet(covs)
    log_norm = (np.log(weights) - 0.5 * (D * np.log(2 * np.pi) + logdets)).astype(dtype)
    return _prior(means, precisions, log_norm)


def synthetic_gmm(n_components: int = 8, dim: int = 69, seed: int = 0) -> GMMPrior:
    """A seeded stand-in mixture (the JAX package's draws), on the CPU."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n_components, dim).astype(np.float32) * 0.1
    precisions = np.stack([np.eye(dim, dtype=np.float32) * 4.0 for _ in range(n_components)])
    log_norm = np.full((n_components,), -0.5 * dim * np.log(2 * np.pi)
                       + 0.5 * dim * np.log(4.0) - np.log(n_components), np.float32)
    return _prior(means, precisions, log_norm)
