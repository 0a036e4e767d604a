"""The posterior weights the Fisher-vector kernels take (CPU).

``_posterior_weights`` turns a diagonal GMM into the (2d, K) weights and
the per-component constant of the log posterior's gemm expansion.  The
constant comes in two f32 parts whose sum is the float64 constant, so
the kernel's log posterior carries no rounding of it that is the same
on every descriptor."""

import numpy as np
import torch

from keystone_tpu_torch.models.gmm import _LOG2PI, _log_gaussians
from keystone_tpu_torch.ops import fisher_kernels as fk


def _gmm(rng, k, d):
    w = rng.random(k) + 0.1
    w /= w.sum()
    mu = rng.normal(size=(k, d))
    var = 0.5 + rng.random((k, d))
    return [a.astype(np.float32) for a in (w, mu, var)]


def test_posterior_weights_reproduce_the_log_posterior():
    rng = np.random.default_rng(4)
    k, d = 24, 16
    w, mu, var = _gmm(rng, k, d)
    wt, cst = fk._posterior_weights(*(torch.from_numpy(a) for a in (w, mu, var)))
    assert wt.dtype == cst.dtype == torch.float32
    assert tuple(wt.shape) == (2 * d, k) and tuple(cst.shape) == (2, k)

    # the constant: f32 rounding of the float64 value, then what it dropped
    w64, mu64, var64 = (a.astype(np.float64) for a in (w, mu, var))
    const = np.log(w64) - 0.5 * (np.log(var64).sum(1) + d * _LOG2PI) - 0.5 * (mu64 * mu64 / var64).sum(1)
    np.testing.assert_array_equal(cst[0].numpy(), const.astype(np.float32))
    hi_lo = cst[0].double().numpy() + cst[1].double().numpy()
    np.testing.assert_allclose(hi_lo, const, rtol=1e-13, atol=0)
    assert np.abs(cst[1].numpy()).max() <= np.abs(np.spacing(cst[0].numpy())).max()

    # rows interleaved (x_j, x_j^2): the expansion gives log w + log N
    x = rng.normal(size=(50, d))
    feats = torch.from_numpy(np.stack([x, x * x], axis=-1).reshape(50, 2 * d))
    got = torch.from_numpy(hi_lo) + feats @ wt.double()
    exact = _log_gaussians(torch.from_numpy(x), torch.from_numpy(mu64), torch.from_numpy(var64),
                           torch.log(torch.from_numpy(w64)))
    torch.testing.assert_close(got, exact, atol=1e-5, rtol=0)


def test_weights_are_cached_per_gmm_tensors():
    """The wrappers' weights: computed once per (w, mu, var) tensors, again
    after an in-place change of one of them, separately for equal values
    in other tensors."""
    rng = np.random.default_rng(5)
    w, mu, var = (torch.from_numpy(a) for a in _gmm(rng, 16, 8))
    first = fk._weights_for(w, mu, var)
    assert fk._weights_for(w, mu, var) is first
    other = fk._weights_for(w.clone(), mu.clone(), var.clone())
    assert other is not first
    torch.testing.assert_close(other, first, atol=0, rtol=0)
    mu.mul_(2.0)
    changed = fk._weights_for(w, mu, var)
    assert changed is not first
    torch.testing.assert_close(changed, fk._posterior_weights(w, mu, var), atol=0, rtol=0)
    assert len(fk._WEIGHTS) <= fk._WEIGHTS_KEPT
