"""Random features, row normalizers, column standardization and samplers
(counterpart of ``keystone_tpu/ops/stats.py`` § CosineRandomFeatures,
RandomSignNode, PaddedFFT, LinearRectifier, SignedHellingerMapper,
NormalizeRows, StandardScaler, StandardScalerModel, Sampler,
ColumnSampler).

The random-feature transformers draw their parameters from a CPU
``torch.Generator`` seeded with ``seed``, so every device draws the same
values; they are not the reference's draws (its generator is another
one): a parity test passes the reference's arrays in through
``convert``.  The samplers are transformers over a ``Dataset``: they read the whole set to
draw from it, so they take no part in stage fusion.  Over a
``StreamDataset`` they sweep it once, keep only the drawn rows, and draw
the rows the same seed draws over the set in memory."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch.models.common import kahan_add
from keystone_tpu_torch.utils.device import resolve_device
from keystone_tpu_torch.utils.stats import rand_matrix_cauchy, rand_matrix_gaussian
from keystone_tpu_torch.workflow.dataset import Dataset, StreamDataset
from keystone_tpu_torch.workflow.estimator import Estimator
from keystone_tpu_torch.workflow.transformer import Transformer, iter_row_chunks, tensor_identity


class CosineRandomFeatures(Transformer):
    """Random Fourier features cos(x·Wᵀ + b) (CosineRandomFeatures.scala,
    TIMIT's featurizer): W's rows ~ γ·Gaussian for the RBF kernel or
    γ·Cauchy for the Laplacian kernel, b ~ Uniform[0, 2π)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)  # (num_out, num_in)
        self.register_buffer("b", b)  # (num_out,)

    @classmethod
    def init(cls, num_input_features: int, num_output_features: int, gamma: float = 1.0, seed: int = 0,
             distribution: str = "gaussian", device="cuda") -> "CosineRandomFeatures":
        """Seeded draws on ``device``."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        shape = (num_output_features, num_input_features)
        if distribution == "gaussian":
            w = rand_matrix_gaussian(g, *shape)
        elif distribution == "cauchy":
            w = rand_matrix_cauchy(g, *shape)
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
        b = torch.rand((num_output_features,), generator=g) * (2 * np.pi)
        return cls((gamma * w).to(dev), b.to(dev))

    def params(self):
        return tensor_identity(self.w, self.b)

    def apply_batch(self, xs, mask=None):
        # the phase x·Wᵀ is unbounded, so a relative rounding of it is an
        # absolute phase error that cos wraps: it stays true f32 (the
        # pipelines turn TF32 off), as the reference keeps it out of bf16
        return torch.cos(torch.matmul(xs, self.w.T) + self.b)


class RandomSignNode(Transformer):
    """Elementwise Rademacher sign flip (RandomSignNode.scala), paired with
    PaddedFFT for fastfood-style random features."""

    def __init__(self, signs: torch.Tensor):
        super().__init__()
        self.register_buffer("signs", signs)

    @classmethod
    def init(cls, num_features: int, seed: int = 0, device="cuda") -> "RandomSignNode":
        bits = torch.rand((num_features,), generator=torch.Generator().manual_seed(int(seed))) < 0.5
        return cls((bits.to(torch.float32) * 2.0 - 1.0).to(resolve_device(device)))

    def params(self):
        return tensor_identity(self.signs)

    def apply_batch(self, xs, mask=None):
        return xs * self.signs


class PaddedFFT(Transformer):
    """Zero-pad the last axis to the next power of two and take its real
    FFT (PaddedFFT.scala, MNIST's featurizer): [Re, Im] of the
    positive-frequency half, concatenated.  The transform is unitary
    (``norm="ortho"``), so the features keep the input's scale, which the
    f32 normal equations downstream need."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        d = xs.shape[-1]
        padded = 1 << (d - 1).bit_length()
        spec = torch.fft.rfft(xs.to(torch.float32), n=padded, dim=-1, norm="ortho")
        return torch.cat([spec.real, spec.imag], dim=-1)


class LinearRectifier(Transformer):
    """max(x − α, maxVal) (LinearRectifier.scala)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        super().__init__()
        self.max_val = float(max_val)
        self.alpha = float(alpha)

    def params(self):
        return (self.max_val, self.alpha)

    def apply_batch(self, xs, mask=None):
        return torch.clamp(xs - self.alpha, min=self.max_val)


class SignedHellingerMapper(Transformer):
    """sign(x)·√|x| — the power normalization after FV encoding."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        out = torch.sign(xs) * torch.sqrt(torch.abs(xs))
        return (out, mask) if mask is not None else out


class NormalizeRows(Transformer):
    """L2 row normalization."""

    def __init__(self, eps: float = 1e-12):
        super().__init__()
        self.eps = float(eps)

    def params(self):
        return (self.eps,)

    def apply_batch(self, xs, mask=None):
        norm = torch.sqrt(torch.sum(xs * xs, dim=-1, keepdim=True))
        out = xs / torch.clamp(norm, min=self.eps)
        return (out, mask) if mask is not None else out


class StandardScalerModel(Transformer):
    """(x − mean) / std, std optional."""

    def __init__(self, mean: torch.Tensor, std: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)

    def params(self):
        return tensor_identity(self.mean, self.std)

    def apply_batch(self, xs, mask=None):
        out = xs - self.mean
        if self.std is not None:
            out = out / self.std
        return out


class StandardScaler(Estimator):
    """Column mean and unbiased std (n − 1 denominator), the std clamped
    below at ``eps`` (nodes/stats/StandardScaler.scala).  A
    ``StreamDataset`` is fitted by ``fit_stream``, out of core.

    The moments are summed in float64 and rounded to f32 once, where the
    reference sums in f32: then a fit over one tensor and a fit over a
    stream of batches, whose sums are taken in other orders, give the
    same f32 mean and std, so that a streamed pipeline scales its rows,
    and draws its landmarks, exactly as the in-memory one."""

    def __init__(self, normalize_std: bool = True, eps: float = 1e-8):
        self.normalize_std = normalize_std
        self.eps = float(eps)

    def params(self):
        return (self.normalize_std, self.eps)

    def fit_dataset(self, data: Dataset) -> StandardScalerModel:
        """The fit on the data's device."""
        if isinstance(data, StreamDataset):
            return self.fit_stream(lambda: (a for a, _ in data.device_batches()))
        return self._fit(data.array[:data.n])

    def fit_arrays(self, x, device="cuda") -> StandardScalerModel:
        """x: (n, d), numpy or a tensor; fitted on ``device``."""
        return self._fit(torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device)))

    def _fit(self, x) -> StandardScalerModel:
        x = x.to(torch.float64)
        n = x.shape[0]
        mean = torch.sum(x, dim=0) / n
        # explicit centering before the square, as the reference: the
        # Σx² − n·mean² shortcut cancels
        xc = x - mean
        return self._model(mean, torch.sum(xc * xc, dim=0), n)

    def _model(self, mean, sq, n) -> StandardScalerModel:
        """The model from the float64 mean and centred square sums."""
        if not self.normalize_std:
            return StandardScalerModel(mean.to(torch.float32), None)
        std = torch.sqrt(sq / max(n - 1.0, 1.0)).to(torch.float32)
        return StandardScalerModel(mean.to(torch.float32), torch.clamp(std, min=self.eps))

    def fit_stream(self, batches) -> StandardScalerModel:
        """Moments over a stream of (n_i, d) batches, numpy or tensors (a
        callable returning a fresh iterator, or a re-iterable), on the
        first batch's device (numpy batches: the card).  Two passes, as
        the reference: the means, then Σ(x − mean)² of explicitly centred
        batches, both sums Kahan-compensated across batches."""
        get = batches if callable(batches) else lambda: iter(batches)
        dev = None

        def staged():
            nonlocal dev
            for b in get():
                if dev is None:
                    dev = b.device if isinstance(b, torch.Tensor) else resolve_device()
                yield torch.as_tensor(b).to(dev, torch.float64)

        s1 = c1 = None
        n = 0
        for x in staged():
            n += x.shape[0]
            s1, c1 = kahan_add(s1, c1, torch.sum(x, dim=0))
        if n == 0:
            raise ValueError("empty batch stream")
        mean = s1 / n
        s2 = c2 = None
        n2 = 0
        for x in staged():
            n2 += x.shape[0]
            xc = x - mean
            s2, c2 = kahan_add(s2, c2, torch.sum(xc * xc, dim=0))
        if n2 != n:
            raise ValueError(f"batch stream is not re-iterable: first pass saw {n} rows, second pass {n2}. Pass a "
                             "callable returning a fresh iterator (or a re-iterable like a list).")
        return self._model(mean, s2, n)


class Sampler(Transformer):
    """Row subsampling with a fixed seed (Sampler.scala): ``size`` rows
    without replacement, drawn by ``np.random.default_rng(seed)`` as the
    reference draws them, so both keep the same rows."""

    fusable = False

    def __init__(self, size: int, seed: int = 0):
        super().__init__()
        self.size = int(size)
        self.seed = int(seed)

    def params(self):
        return (self.size, self.seed)

    def _kept(self, n: int) -> np.ndarray:
        return np.sort(np.random.default_rng(self.seed).choice(n, size=min(self.size, n), replace=False))

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if isinstance(ds, StreamDataset):
            return self._apply_stream(ds)
        idx = torch.from_numpy(self._kept(ds.n)).to(ds.device)
        return Dataset(ds.array[idx], mask=None if ds.mask is None else ds.mask[idx])

    def _apply_stream(self, ds: StreamDataset) -> Dataset:
        """The kept rows of a stream, gathered batch by batch by their
        global index."""
        kept = self._kept(ds.n)
        rows, masks, lo = [], [], 0
        for arr, mask in ds.device_batches():
            hi = lo + arr.shape[0]
            sel = kept[(kept >= lo) & (kept < hi)] - lo
            if sel.size:
                idx = torch.from_numpy(sel).to(arr.device)
                rows.append(arr[idx])
                if mask is not None:
                    masks.append(mask[idx])
            lo = hi
        _check_stream_rows(lo, ds.n)
        return Dataset(torch.cat(rows), mask=torch.cat(masks) if masks else None)

    def apply_arrays(self, x):
        """The kept rows of ``x`` (n, ...), a numpy array or a tensor, in order."""
        idx = self._kept(x.shape[0])
        return x[idx] if isinstance(x, np.ndarray) else x[torch.from_numpy(idx).to(x.device)]

    def apply_batch(self, xs, mask=None):
        return self.apply_arrays(xs)


class ColumnSampler(Transformer):
    """``num_samples`` descriptors an item, drawn uniformly with
    replacement from the item's valid descriptors (ColumnSampler.scala:
    columns of each image's descriptor matrix, sampled before the PCA and
    GMM fits).  Input: a Dataset of (n, T, d) sets and an (n, T) mask;
    output: the flat (n·num_samples, d) rows, item by item.

    The draws are (n, num_samples) uniforms from a CPU ``torch.Generator``
    seeded with ``seed``, so every device samples the same rows; item i
    takes row i of them, whatever the chunks a dataset is sampled in (the
    reference folds the global item index into its key for the same
    end).  A rank's row slice takes its items' global rows of the draws,
    and its output is the slice of the flat rows.  An item with no valid
    descriptor yields copies of its last (padding) row, where the
    reference's draw is undefined."""

    fusable = False

    def __init__(self, num_samples: int, seed: int = 0):
        super().__init__()
        self.num_samples = int(num_samples)
        self.seed = int(seed)

    def params(self):
        return (self.num_samples, self.seed)

    def draws(self, n: int) -> torch.Tensor:
        """(n, num_samples) float64 uniforms in [0, 1): items 0..n−1's draws."""
        g = torch.Generator().manual_seed(self.seed)
        return torch.rand((n, self.num_samples), generator=g, dtype=torch.float64)

    def sample(self, xs, mask, u) -> torch.Tensor:
        """The rows that draws ``u`` (m, num_samples) pick from sets xs
        (m, T, d) under ``mask`` (m, T) or None: (m·num_samples, d)."""
        m, t, d = xs.shape
        valid = torch.ones((m, t), dtype=torch.bool, device=xs.device) if mask is None else mask > 0
        cum = torch.cumsum(valid.to(torch.int64), dim=1)  # valid descriptors up to each position
        j = (u.to(xs.device) * cum[:, -1:]).to(torch.int64)  # the j-th valid one, 0-based
        idx = torch.clamp(torch.searchsorted(cum, j + 1), max=t - 1)
        return torch.gather(xs, 1, idx[..., None].expand(m, self.num_samples, d)).reshape(-1, d)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        """The flat sample of every item, drawn chunk by chunk (the
        transformers' row chunks, or a stream's batches) with each item's
        own draws: the same rows, however the set is cut."""
        if isinstance(ds, StreamDataset):
            return self._apply_stream(ds)
        xs = ds.array
        if xs.ndim != 3:
            raise ValueError("ColumnSampler expects (n, max_k, d) descriptor sets")
        u = self.draws(ds.n)
        if ds.is_rank_slice:
            # a rank's items are global items rank_start ..: their rows of
            # the draws (the padding items' rows are zeros)
            u = u[ds.rank_start:ds.rank_start + xs.shape[0]]
            u = torch.cat([u, u.new_zeros((xs.shape[0] - u.shape[0], u.shape[1]))])
        u = u.to(xs.device)
        parts = [self.sample(a, m, u[i:i + a.shape[0]]) for a, m, i in iter_row_chunks(xs, ds.mask)]
        out = Dataset(parts[0] if len(parts) == 1 else torch.cat(parts))
        if ds.is_rank_slice:  # the flat rows of the slice's items, the padding items' after them
            s = self.num_samples
            out.n, out.rank_rows, out.rank_start = ds.n * s, ds.rank_rows * s, ds.rank_start * s
        return out

    def _apply_stream(self, ds: StreamDataset) -> Dataset:
        """One sweep of a descriptor stream, each batch sampled with its
        items' rows of the draws; only the samples stay."""
        u = self.draws(ds.n)
        parts, lo = [], 0
        for xs, mask in ds.device_batches():
            if xs.ndim != 3:
                raise ValueError("ColumnSampler expects (n, max_k, d) descriptor sets")
            parts.append(self.sample(xs, mask, u[lo:lo + xs.shape[0]]))
            lo += xs.shape[0]
        _check_stream_rows(lo, ds.n)
        return Dataset(torch.cat(parts))

    def apply_arrays(self, xs, mask=None) -> torch.Tensor:
        return self.sample(xs, mask, self.draws(xs.shape[0]))

    def apply_batch(self, xs, mask=None):
        return self.apply_arrays(xs, mask)


def _check_stream_rows(got: int, n: int) -> None:
    if got != n:
        raise ValueError(f"stream produced {got} items, expected {n}")
