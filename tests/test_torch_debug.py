"""The port's debug helpers and test fixtures (keystone_tpu_torch/utils/
debug.py and test_utils.py) against the reference's
(keystone_tpu/utils/debug.py, test_utils.py): tests/test_aux.py's
debug case and the fixtures' values, on the same numpy inputs.  The
port's ``checked`` runs the function and checks each floating output
with one reduction; it names the output at fault.

Tolerances: none; values are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.utils import debug as ref_debug
from keystone_tpu.utils import test_utils as ref_test_utils
from keystone_tpu.workflow import Dataset as RefDataset
from keystone_tpu_torch.utils import debug, test_utils
from keystone_tpu_torch.workflow.dataset import Dataset


@pytest.mark.parametrize("value", [np.ones(3), np.array([1.0, np.nan]), np.array([np.inf, 2.0, -np.inf]),
                                   np.arange(4)])
def test_assert_all_finite_matches_the_reference(value):
    def outcome(fn, x):
        try:
            fn(x, "v")
            return None
        except FloatingPointError as e:
            return str(e)

    want = outcome(ref_debug.assert_all_finite, value)
    assert outcome(debug.assert_all_finite, value) == want
    assert outcome(debug.assert_all_finite, torch.as_tensor(value)) == want
    assert (want is None) == bool(np.all(np.isfinite(value)))


def test_checked_raises_where_the_reference_raises():
    with pytest.raises(Exception):
        ref_debug.checked(lambda x: jnp.log(x))(jnp.asarray(-1.0))
    with pytest.raises(FloatingPointError, match="log: output: 1 non-finite"):
        debug.checked(torch.log)(torch.tensor(-1.0))
    got = debug.checked(torch.log)(torch.tensor(2.0))
    assert got.item() == pytest.approx(float(np.log(2.0)))
    assert float(ref_debug.checked(lambda x: jnp.log(x))(jnp.asarray(2.0))) == pytest.approx(got.item())


def test_checked_names_the_output_at_fault():
    def f(x):
        return {"w": x + 1, "parts": (x, x / 0.0), "n": 3}

    with pytest.raises(FloatingPointError, match=r"output\['parts'\]\[1\]"):
        debug.checked(f)(torch.ones(2))
    ok = debug.checked(lambda x: (x, torch.arange(3)))(torch.ones(2))
    assert ok[0].tolist() == [1.0, 1.0]


def test_nan_guard_dataset_matches_the_reference():
    good = np.ones((3, 2), np.float32)
    bad = np.array([[1.0, np.nan]], np.float32)
    assert debug.nan_guard_dataset(Dataset(good, device="cpu")).array.shape == (3, 2)
    ref_debug.nan_guard_dataset(RefDataset(good))
    with pytest.raises(FloatingPointError):
        ref_debug.nan_guard_dataset(RefDataset(bad))
    with pytest.raises(FloatingPointError, match="dataset: 1 non-finite"):
        debug.nan_guard_dataset(Dataset(bad, device="cpu"))
    host = Dataset(["doc", "with nan"], device="cpu")
    assert debug.nan_guard_dataset(host) is host


@pytest.mark.parametrize("kw", [dict(), dict(height=8, width=5, channels=1, seed=3)])
def test_gen_image_matches_the_reference(kw):
    got = test_utils.gen_image(device="cpu", **kw)
    want = ref_test_utils.gen_image(**kw)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.metadata.shape == want.metadata.shape


def test_gen_image_batch_matches_the_reference():
    np.testing.assert_array_equal(test_utils.gen_image_batch(3, 4, 6, 2, seed=1),
                                  ref_test_utils.gen_image_batch(3, 4, 6, 2, seed=1))


@pytest.mark.parametrize("name", ["gradient", "checkerboard", "blobs"])
def test_load_test_image_matches_the_reference(name):
    got = test_utils.load_test_image(name, size=24, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref_test_utils.load_test_image(name, size=24).data))


def test_fixtures_default_to_the_card():
    with pytest.raises(ValueError):
        test_utils.load_test_image("nope", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    for make in (test_utils.gen_image, test_utils.load_test_image):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
