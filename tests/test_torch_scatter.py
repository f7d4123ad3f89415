"""Kernel K7 (``scatter_rows_``, the in-place row scatter) and the write-back
of ``subset_apply`` that runs through it, held on the CPU against the JAX
package's Pallas row scatter in interpret mode (as tests/test_ops.py runs
it). The CUDA kernel itself is checked against its plain version on the
card by ``chip_smoke.py`` (phase 2). Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_scatter_rows_plain_matches_pallas_interpret(dtype):
    """u8 [8, 32, 128, 3] and f32 [6, 16, 128] (the shapes Mosaic's tiling
    takes), 3 rows in a shuffled order: written rows equal the sub-batch and
    the Pallas result exactly; every other row byte-identical to dst."""
    from mmtrs_tpu.ops.pallas.scatter_kernel import scatter_rows_pallas
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES
    from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_, scatter_rows_ref

    rng = np.random.default_rng(7)
    shape = (8, 32, 128, 3) if dtype == np.uint8 else (6, 16, 128)
    dst = (rng.uniform(0, 255, shape) if dtype == np.float32 else rng.integers(0, 256, shape)).astype(dtype)
    sub = (rng.uniform(0, 255, (3, *shape[1:])) if dtype == np.float32
           else rng.integers(0, 256, (3, *shape[1:]))).astype(dtype)
    idx = np.array([5, 1, 4], np.int64)
    want = np.asarray(scatter_rows_pallas(jnp.asarray(dst), jnp.asarray(sub), jnp.asarray(idx.astype(np.int32)),
                                          interpret=True))
    before = LAUNCHES["scatter_rows"]
    for fn in (scatter_rows_ref, scatter_rows_):
        got_t = _t(dst)
        out = fn(got_t, _t(sub), _t(idx))
        assert out is got_t  # in place
        got = out.numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[idx], sub)
        keep = np.setdiff1d(np.arange(shape[0]), idx)
        assert got[keep].tobytes() == dst[keep].tobytes()
    assert LAUNCHES["scatter_rows"] == before  # CPU tensors: the plain version, no launch


def test_scatter_rows_empty_subset_is_a_no_op():
    from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_

    dst = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    out = scatter_rows_(dst.clone(), torch.zeros((0, 6)), torch.zeros(0, dtype=torch.int64))
    assert torch.equal(out, dst)


def _bad_cases():
    u8 = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    sub = torch.ones((2, 8, 8, 3), dtype=torch.uint8)
    idx = torch.tensor([0, 2])
    return {
        "dst_dtype": ((u8.int(), sub.int(), idx), "contiguous"),
        "sub_dtype": ((u8, sub.float(), idx), "uint8"),
        "trailing_shape": ((u8, torch.ones((2, 8, 4, 3), dtype=torch.uint8), idx), "do not fit"),
        "idx_length": ((u8, sub, torch.tensor([0, 1, 2])), "do not fit"),
        "idx_dtype": ((u8, sub, idx.int()), "int64"),
        "idx_2d": ((u8, sub, idx[None]), "1 dims"),
        "dst_noncontig": ((u8.transpose(1, 2), sub, idx), "contiguous"),
        "sub_noncontig": ((u8, torch.ones((2, 8, 8, 3), dtype=torch.uint8).transpose(1, 2), idx), "contiguous"),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_scatter_rows_rejects_bad_inputs(case):
    from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_

    args, msg = _bad_cases()[case]
    with pytest.raises(ValueError, match=msg):
        scatter_rows_(*args)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_subset_apply_leaves_its_input_unmutated(dtype):
    """The write-back goes into a copy: the caller's batch keeps its bytes,
    the result has the op's rows where ``on`` and the input's elsewhere."""
    from mmtrs_tpu_torch.ops.augment import subset_apply

    rng = np.random.default_rng(3)
    x = _t(rng.integers(0, 200, (6, 8, 8, 3)).astype(np.uint8)).to(dtype)
    keep = x.clone()
    on = torch.tensor([True, False, False, True, True, False])
    out = subset_apply(lambda s, k: s + k.to(dtype)[:, None, None, None], x, on, torch.arange(6))
    assert torch.equal(x, keep)
    assert out.data_ptr() != x.data_ptr()
    want = torch.where(on[:, None, None, None], keep + torch.arange(6).to(dtype)[:, None, None, None], keep)
    assert torch.equal(out, want)
