"""K-means++ clustering (counterpart of ``keystone_tpu/models/kmeans.py``
§ _sq_dists, KMeansModel, KMeansPlusPlusEstimator, _kmeans_fit).

k-means++ seeding draws each next centre ∝ its squared distance to the
nearest centre so far, then Lloyd iterations move each centre to the
mean of its rows (argmin, the lowest index on ties; an empty cluster
keeps its centre).  The draws come from an explicit ``torch.Generator``:
the reference draws with its framework's generator, which the port cannot repeat,
so parity is held from given centres (``_lloyd``).  With a run ledger
each Lloyd iteration reports its distortion and centre shift
(``solver.epoch``, a host read); without one it reads nothing back.
"""

from __future__ import annotations

import torch

from keystone_tpu_torch.obs import ledger
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.workflow.transformer import Transformer


def _sq_dists(x, centers):
    """(..., k) squared distances by the gemm expansion; x is (..., d)."""
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    cn = torch.sum(centers * centers, dim=-1)
    return xn - 2.0 * (x @ centers.T) + cn


class KMeansModel(Transformer):
    """One-hot nearest-centre assignment (KMeansPlusPlus.scala § KMeansModel)."""

    def __init__(self, centers: torch.Tensor):
        super().__init__()
        self.register_buffer("centers", centers)  # (k, d)

    def apply_batch(self, xs, mask=None):
        k = self.centers.shape[0]
        onehot = torch.nn.functional.one_hot(self.assign(xs), k).to(xs.dtype)
        if mask is not None:
            # ragged descriptor sets: padding rows cast no vote, the mask stays
            return onehot * mask[..., None], mask
        return onehot

    def assign(self, xs):
        return torch.argmin(_sq_dists(xs, self.centers), dim=-1)


def generator(seed: int, device) -> torch.Generator:
    """The fits' source of draws: a generator on ``device`` seeded with
    ``seed``, so that a fit repeats on one device."""
    return torch.Generator(device=device).manual_seed(int(seed))


class KMeansPlusPlusEstimator:
    def __init__(self, num_means: int, max_iterations: int = 20, seed: int = 0):
        self.num_means = int(num_means)
        self.max_iterations = int(max_iterations)
        self.seed = int(seed)

    def fit_arrays(self, x, device="cuda") -> KMeansModel:
        """x: (n, d), numpy or a tensor; fitted in f32 on ``device``."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        row_ok = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
        return KMeansModel(_kmeans_fit(x, row_ok, self.num_means, self.max_iterations,
                                       generator(self.seed, dev)))


def _kmeans_seed(x, row_ok, k: int, gen: torch.Generator):
    """k-means++ seeding: the first centre uniform over the rows row_ok
    keeps, each next one ∝ its squared distance to the nearest centre so
    far.  The +1e-30 is the reference's: a set of duplicate rows, all at
    distance 0, still draws.  The nearest distance is kept as a running
    minimum, one (n,) update a centre.  Nothing waits on the host: the
    drawn index stays a (1,) tensor (indexing with a 0-d one reads it
    back as a Python int)."""
    n_rows = x.shape[0]
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[:1] = x.index_select(0, torch.multinomial(row_ok + 1e-30, 1, generator=gen))
    xn = torch.sum(x * x, dim=1)
    nearest = torch.full((n_rows,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        c = centers[i - 1]
        nearest = torch.minimum(nearest, xn - 2.0 * (x @ c) + torch.dot(c, c))
        d = torch.clamp(nearest, min=0.0) * row_ok
        centers[i:i + 1] = x.index_select(0, torch.multinomial(d + 1e-30, 1, generator=gen))
    return centers


def _lloyd(x, row_ok, centers, iters: int):
    """``iters`` Lloyd steps from ``centers`` (the deterministic part of
    the fit): each row to its nearest centre, each centre to its rows'
    mean; an empty cluster keeps its centre."""
    k = centers.shape[0]
    observe = ledger.solver_obs()
    for it in range(iters):
        d = _sq_dists(x, centers)
        assign = torch.nn.functional.one_hot(torch.argmin(d, dim=1), k)
        assign = assign.to(x.dtype) * row_ok[:, None]
        counts = torch.sum(assign, dim=0)
        new = (assign.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        new = torch.where((counts > 0)[:, None], new, centers)
        if observe:
            distortion = torch.sum(torch.clamp(torch.min(d, dim=1).values, min=0.0) * row_ok)
            shift = torch.sqrt(torch.sum((new - centers) ** 2))
            ledger.solver_epoch("kmeans", epoch=it, distortion=float(distortion), center_shift=float(shift))
        centers = new
    return centers


def _kmeans_fit(x, row_ok, k: int, iters: int, gen: torch.Generator):
    """row_ok: (n_rows,) 1.0 for real rows, 0.0 for padding or invalid ones."""
    return _lloyd(x, row_ok, _kmeans_seed(x, row_ok, k, gen), iters)
