"""The port's LPIPS (utils/lpips.py) against the JAX package's
(utils/lpips_jax.py) on random weights with the lpips-alex shapes, and
eval_rgb's LPIPS resolution: a weight file from $HOLOSCENE_LPIPS_NPZ, and
NaN with a warning when there is none. Tolerance: relative 1e-4 (float32
convolutions summed in another order)."""

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from holoscene_tpu.utils import lpips_jax
from holoscene_tpu_torch.convert import lpips_params_from_jax
from holoscene_tpu_torch.utils import eval_rgb as teval
from holoscene_tpu_torch.utils import lpips as tlp


def _pair(seed, size=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_random_params_are_jax_draws():
    jp, tp = lpips_jax.init_random_params(3), tlp.init_random_params(3)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_pair_matches_jax(seed):
    params = tlp.init_random_params(seed)
    a, b = _pair(seed)
    want = float(lpips_jax.lpips_pair(params, a, b))
    got = float(tlp.lpips_pair(lpips_params_from_jax(params, "cpu"),
                               torch.tensor(a), torch.tensor(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    same = float(tlp.lpips_pair(tlp.params_to_torch(params, "cpu"),
                                torch.tensor(a), torch.tensor(a)))
    assert same == 0.0


def test_npz_round_trip_into_eval_rgb(tmp_path, monkeypatch):
    params = tlp.init_random_params(5)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **params)
    monkeypatch.setenv("HOLOSCENE_LPIPS_NPZ", str(path))
    a, b = _pair(7)
    m = teval.eval_rgb(a, b)
    want = float(lpips_jax.lpips_pair(lpips_jax.load_lpips_npz(str(path)),
                                      a, b))
    np.testing.assert_allclose(m["lpips"], want, rtol=1e-4)
    assert m["psnr"] == teval.psnr(a, b)
    np.testing.assert_allclose(lpips_jax.lpips_from_npz(str(path))(a, b),
                               m["lpips"], rtol=1e-4)


def test_no_weight_file_gives_nan_and_a_warning(tmp_path, monkeypatch):
    monkeypatch.setenv("HOLOSCENE_LPIPS_NPZ", str(tmp_path / "absent.npz"))
    assert teval.lpips_fn() is None
    a, b = _pair(8, 32)
    with pytest.warns(UserWarning, match="LPIPS"):
        m = teval.eval_rgb(a, b)
    assert np.isnan(m["lpips"])


def test_bad_shapes_are_refused(tmp_path):
    params = tlp.init_random_params(0)
    params["lin2_w"] = params["lin2_w"][:10]
    np.savez(tmp_path / "bad.npz", **params)
    with pytest.raises(ValueError, match="tap 2"):
        tlp.load_lpips_npz(str(tmp_path / "bad.npz"))
