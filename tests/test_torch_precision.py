"""The port's precision policies against respatpu's."""
import numpy as np
import pytest
import torch

import respatpu.precision as jprec

import respatpu_torch.precision as tprec


@pytest.mark.parametrize("name,dtype,flush", [
    ("fp32", torch.float32, False), ("fp32_ftz", torch.float32, True),
    ("bf16", torch.bfloat16, False), ("fp64", torch.float64, False),
    ("df64", torch.float64, False), ("FP32", torch.float32, False)])
def test_policy_table(name, dtype, flush):
    p = tprec.get_policy(name)
    assert p.dtype == dtype and p.flush_to_zero == flush
    assert p.accum_dtype == (torch.float64 if dtype == torch.float64
                                          else torch.float32)
    assert tprec.get_policy(p) is p
    # every respatpu policy name resolves in the port
    jprec.get_policy(name)


def test_df64_is_an_alias_of_fp64():
    assert tprec.get_policy("df64") is tprec.FP64
    with pytest.raises(ValueError):
        tprec.get_policy("fp16")


def test_constants_match_respatpu():
    assert tprec.FP32_MAX == jprec.FP32_MAX
    assert tprec.FP32_MIN_NORMAL == jprec.FP32_MIN_NORMAL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ftz_on_subnormals(dtype):
    tiny = torch.finfo(dtype).tiny
    x = torch.tensor([tiny / 4, -tiny / 2, tiny, -tiny, 1.0, 0.0, float("nan")], dtype=dtype)
    y = tprec.ftz(x)
    assert y[:2].tolist() == [0.0, 0.0] and not torch.signbit(y[1])
    assert y[2:6].tolist() == [tiny, -tiny, 1.0, 0.0] and torch.isnan(y[6])
    assert tprec.ftz(x, enabled=False) is x
    if dtype == torch.float32:  # respatpu runs JAX without 64-bit types
        np.testing.assert_array_equal(y.numpy(), np.asarray(jprec.ftz(x.numpy())))


def test_cast_host_matches_respatpu():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(5000) * 10.0 ** rng.integers(-45, 5, 5000)
    for name in ("fp32", "fp32_ftz"):
        (ref,) = jprec.get_policy(name).cast_host(v)
        assert tprec.get_policy(name).cast_host(v).numpy().tobytes() == ref.tobytes()
    assert torch.equal(tprec.get_policy("fp64").cast_host(v), torch.from_numpy(v))
    # bf16 rounds through fp32, as respatpu's GSELL upload does
    bf = tprec.get_policy("bf16").cast_host(v)
    assert torch.equal(bf, torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16))


def test_downcast_check_matches_respatpu():
    v = np.array([1.0, -3e38, 4e38, -1e39, 1e-50, np.inf])
    out, n = tprec.downcast_check(v)
    ref, n_ref = jprec.downcast_check(v)
    assert n == n_ref == 3
    assert out.tobytes() == ref.tobytes()
