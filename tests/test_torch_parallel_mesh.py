"""``mmtrs_tpu_torch.parallel`` and ``graft_entry`` on the CPU: the helpers
of ``parallel.mesh`` in a 2-rank gloo group (``shard_batch``,
``replicate``, ``all_reduce_grads_``, ``data_parallel_eval`` with its pad
rows, the differentiable ``all_sum``, BatchNorm's global moments and the
rank's rows of a global dropout mask under ``sharded``), ``pad_to_multiple``
against JAX's, a failing rank, the dryrun twin through
``dryrun_multichip(2, device="cpu")``, and ``entry``.

The ranks are ``python -m tests.test_torch_parallel_mesh <mode> <out>``
processes that ``parallel.dryrun.launch`` starts (one torch thread each, a
FileStore in the test's tmp_path).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


def _bn_input():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (8, 4, 3, 3)).astype(np.float32)
    x[:4] += 3.0  # rank 0's rows: another mean than rank 1's
    r = rng.normal(0, 1, (8, 4, 3, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(r)


def _bn_run(group):
    """A train-mode BatchNorm on [8, 4, 3, 3] (the rank's rows under a
    group): its output, running statistics and the gradients of Σ out·r
    (input rows, scale, bias; the parameters' summed over the ranks)."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import BatchNorm
    from mmtrs_tpu_torch.parallel.mesh import sharded

    x, r = _bn_input()
    rows = slice(None) if group is None else group.rows(8)
    x = x[rows].clone().requires_grad_(True)
    bn = BatchNorm(4).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.0, -0.2, 0.3]))
    with sharded(group):
        y = bn(x)
    (y * r[rows]).sum().backward()
    gw, gb = bn.weight.grad.clone(), bn.bias.grad.clone()
    if group is not None:
        torch.distributed.all_reduce(gw)
        torch.distributed.all_reduce(gb)
    return {"y": y.detach().tolist(), "gx": x.grad.tolist(), "gw": gw.tolist(), "gb": gb.tolist(),
            "mean": bn.running_mean.tolist(), "var": bn.running_var.tolist()}


def _helpers(group) -> dict:
    from mmtrs_tpu_torch.models.backbones.efficientnet import dropout
    from mmtrs_tpu_torch.parallel.mesh import all_reduce_grads_, data_parallel_eval, replicate, shard_batch, sharded

    out = {}
    tree = {"x": np.arange(16).reshape(8, 2), "t": torch.arange(6), "cw": np.array([1.0, 1.3, 0.7]),
            "s": np.float32(2.0)}
    sh = shard_batch(group, tree)
    out["shard"] = {"x": sh["x"].tolist(), "t": sh["t"].tolist(), "cw": sh["cw"].tolist(), "s": float(sh["s"])}

    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(group.rank + 1.0)
        lin.bias.fill_(-group.rank)
    replicate(group, lin)
    out["replicated"] = [lin.weight.tolist(), lin.bias.tolist()]

    p = torch.nn.Parameter(torch.zeros(5))
    p.grad = torch.full((5,), group.rank + 1.0)
    q = torch.nn.Parameter(torch.zeros(2, 2))  # no gradient: left out
    stats = all_reduce_grads_([p, q], group, torch.tensor([2.0 * group.rank]))
    out["grad"], out["stats"], out["grad_syncs"], out["q_grad"] = p.grad.tolist(), stats.tolist(), group.grad_syncs, q.grad

    seen = []
    x = torch.arange(18, dtype=torch.float32).reshape(9, 2) + 1

    def fn(a):
        seen.append(a.tolist())
        return a * 2, a.sum(1)

    doubled, sums = data_parallel_eval(group, fn, x)
    out["eval"] = [doubled.tolist(), sums.tolist()]
    out["seen"] = seen[0]

    v = torch.tensor([1.0, 2.0]) * (group.rank + 1)
    v.requires_grad_(True)
    s = group.all_sum(v)
    (s * torch.tensor([1.0, 10.0])).sum().backward()
    out["all_sum"], out["all_sum_grad"] = s.tolist(), v.grad.tolist()

    g = torch.Generator().manual_seed(5)
    with sharded(group):
        kept = dropout(torch.ones(4, 6), 0.5, g)
    out["dropout"] = kept.tolist()
    out["bn"] = _bn_run(group)
    return out


def _rank_main(mode: str, out: Path) -> None:
    from mmtrs_tpu_torch.parallel.mesh import group_from_env

    torch.set_num_threads(1)
    group, _ = group_from_env()
    try:
        if mode == "fail":
            if group.rank == 1:
                raise ValueError("a planted failure in rank 1")
            torch.distributed.barrier()  # never passes: launch must stop this rank
        res = _helpers(group)
    finally:
        group.close()
    (out / f"rank{group.rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from mmtrs_tpu_torch.parallel.dryrun import launch

    out = tmp_path_factory.mktemp("ranks")
    launch(2, "tests.test_torch_parallel_mesh", ["helpers", out], device="cpu", timeout=300, workdir=out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_pad_to_multiple_matches_jax():
    """pad_to_multiple on numpy arrays equals JAX's (pad rows = row 0, the
    real count), and a tensor is padded the same way."""
    from mmtrs_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from mmtrs_tpu_torch.parallel.mesh import pad_to_multiple

    for n, m in ((10, 8), (10, 2), (8, 4), (1, 3), (17, 2)):
        arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        (got, real), (want, want_real) = pad_to_multiple(arr, m), jax_pad(arr, m)
        assert real == want_real == n and got.dtype == want.dtype and np.array_equal(got, want)
        t, treal = pad_to_multiple(torch.from_numpy(arr), m)
        assert treal == n and np.array_equal(t.numpy(), want)


def test_shard_batch(ranks):
    """Each rank takes its contiguous rows of the leaves whose axis 0 splits
    over the group; a [3] leaf and the scalar stay whole."""
    for r, res in enumerate(ranks):
        assert res["shard"]["x"] == np.arange(16).reshape(8, 2)[4 * r : 4 * r + 4].tolist()
        assert res["shard"]["t"] == list(range(3 * r, 3 * r + 3))
        assert res["shard"]["cw"] == [1.0, 1.3, 0.7] and res["shard"]["s"] == 2.0


def test_replicate_broadcasts_rank0(ranks):
    assert ranks[0]["replicated"] == ranks[1]["replicated"] == [[[1.0] * 3] * 2, [0.0, 0.0]]


def test_all_reduce_grads_averages(ranks):
    """The gradient is the ranks' mean (1.5), the statistic riding along too,
    a parameter without a gradient is left without one; one sync counted."""
    for res in ranks:
        assert res["grad"] == [1.5] * 5 and res["stats"] == [1.0] and res["q_grad"] is None
        assert res["grad_syncs"] == 1


def test_data_parallel_eval_pads_with_row0_and_gathers_in_order(ranks):
    """9 rows over 2 ranks: padded to 10 with row 0, rank 0 scores rows 0-4,
    rank 1 rows 5-8 and the pad; every rank ends with the 9 outputs in
    order, as one call on the whole batch gives them."""
    x = np.arange(18, dtype=np.float32).reshape(9, 2) + 1
    assert ranks[0]["seen"] == x[:5].tolist()
    assert ranks[1]["seen"] == x[5:].tolist() + [x[0].tolist()]
    for res in ranks:
        assert res["eval"] == [(x * 2).tolist(), x.sum(1).tolist()]


def test_all_sum_is_differentiable(ranks):
    """Σ over the ranks of [1, 2]·(rank + 1) is [3, 6]; the gradient of
    Σ s·[1, 10] reaching each rank's input is the ranks' summed upstream
    gradient, [2, 20]."""
    for res in ranks:
        assert res["all_sum"] == [3.0, 6.0] and res["all_sum_grad"] == [2.0, 20.0]


def test_dropout_mask_is_the_global_masks_rows(ranks):
    """Under ``sharded``, rank r's mask is rows [4r, 4r + 4) of the mask one
    process draws for the 8-row batch from the same generator state."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import dropout

    want = dropout(torch.ones(8, 6), 0.5, torch.Generator().manual_seed(5))
    assert 0 < int((want == 0).sum()) < 48
    for r, res in enumerate(ranks):
        assert res["dropout"] == want[4 * r : 4 * r + 4].tolist()


def test_batchnorm_takes_the_global_moments(ranks):
    """BatchNorm over the group equals one process on the whole batch: the
    rank's output rows and input gradient rows, the running statistics and
    the parameters' gradients summed over the ranks (f32, 1e-5), on shards
    whose means differ by 3."""
    one = _bn_run(None)
    for r, res in enumerate(ranks):
        rows = slice(4 * r, 4 * r + 4)
        for key in ("y", "gx"):
            np.testing.assert_allclose(res["bn"][key], np.array(one[key])[rows], rtol=1e-5, atol=1e-5, err_msg=key)
        for key in ("gw", "gb", "mean", "var"):
            np.testing.assert_allclose(res["bn"][key], one[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_bag_draws_are_shard_invariant():
    """The MIL bag draws are per origin id: a shard's draws are the rows of
    the whole batch's."""
    from mmtrs_tpu_torch.models.mil import BagDraws

    oids = np.array([5, 9, 9, 2, 40, 7, 1, 3])
    whole = BagDraws.draw(3, oids, 4, (0.4, 1.0), hflip_p=0.5)
    for rows in (slice(0, 4), slice(4, 8)):
        part = BagDraws.draw(3, oids[rows], 4, (0.4, 1.0), hflip_p=0.5)
        for f in ("area", "y0", "x0", "flip"):
            assert torch.equal(getattr(part, f), getattr(whole, f)[rows]), f


def test_skew_angle_does_not_depend_on_the_batch():
    """deskew's angle of an image is the same bits in any batch (its edge
    moments are exact integer sums), so the augmentation chain sharded by
    batch is the one-process batch bit for bit; and it agrees with JAX's
    estimate on the same teeth within 1e-3°."""
    import jax.numpy as jnp

    from mmtrs_tpu.ops.deskew import estimate_skew_angle as jax_angle
    from mmtrs_tpu_torch.ops.deskew import estimate_skew_angle
    from mmtrs_tpu_torch.synth import synth_teeth

    teeth = synth_teeth(6, 256, seed=4, angles_deg=[30.0, -25.0, 5.0, 60.0, -70.0, 0.0])
    whole = estimate_skew_angle(torch.from_numpy(teeth))
    parts = torch.cat([estimate_skew_angle(torch.from_numpy(teeth[i : i + k])) for i, k in ((0, 1), (1, 2), (3, 3))])
    assert torch.equal(whole, parts)
    want = np.asarray(jax_angle(jnp.asarray(teeth)))
    assert np.abs(whole.numpy() - want).max() <= 1e-3


def test_failing_rank_fails_the_launch(tmp_path):
    """A rank that raises makes ``launch`` stop the other (blocked in a
    collective) and raise with the failing rank's stderr."""
    from mmtrs_tpu_torch.parallel.dryrun import launch

    with pytest.raises(RuntimeError, match="rank 1 of 2(.|\n)*a planted failure in rank 1"):
        launch(2, "tests.test_torch_parallel_mesh", ["fail", tmp_path], device="cpu", timeout=120, workdir=tmp_path)


def test_backends_are_explicit():
    """nccl is refused for CPU ranks and for a rank without a CUDA device;
    an unknown backend is refused."""
    from mmtrs_tpu_torch.parallel.dryrun import launch
    from mmtrs_tpu_torch.parallel.mesh import make_group

    with pytest.raises(ValueError, match="gloo"):
        launch(2, "tests.test_torch_parallel_mesh", device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="nccl needs"):
        make_group(1, 0, "nccl", "unused", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_group(1, 0, "mpi", "unused")


def test_launch_and_spawn_default_to_the_card(monkeypatch, tmp_path):
    """With no ``device``, ``launch`` and ``spawn`` take the card, and raise
    by name where none is visible, before any rank starts."""
    import torch

    from mmtrs_tpu_torch.parallel.dryrun import launch, spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(2, "tests.test_torch_parallel_mesh", ["fail", tmp_path], workdir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(2, out=tmp_path)
    assert not list(tmp_path.iterdir())


def test_dryrun_multichip_on_cpu(capsys):
    """``dryrun_multichip(2, device="cpu")``: two gloo ranks run the three
    families and rank 0 prints the OK line."""
    from mmtrs_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out
    assert "[dryrun] OK: 2x cpu ranks over gloo" in line and "MIL DP steps" in line


def test_dryrun_multichip_needs_a_card_by_default(monkeypatch):
    """With no device given it wants the card: without one it raises and
    starts no rank on the CPU."""
    from mmtrs_tpu_torch.graft_entry import dryrun_multichip
    from mmtrs_tpu_torch.parallel import dryrun

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setattr(dryrun, "launch", lambda *a, **k: pytest.fail("a rank was started"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_entry_is_the_b4_bf16_forward():
    """``entry(device="cpu")``: JAX's example arguments (img f32 zeros
    [4, 380, 380, 3], tab f32 zeros [4, 9]) and the B4 MMJointDualHead in
    bf16, eval mode; its forward gives two f32 logits of 4 rows."""
    from mmtrs_tpu_torch.graft_entry import entry
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead

    forward, (img, tab) = entry(device="cpu")
    assert (tuple(img.shape), img.dtype, tuple(tab.shape), tab.dtype) == ((4, 380, 380, 3), torch.float32,
                                                                          (4, 9), torch.float32)
    assert not img.any() and not tab.any()
    model = forward.args[0]
    assert isinstance(model, MMJointDualHead) and not model.training
    assert model.backbone.variant == "b4" and model.backbone.dtype == torch.bfloat16
    hard, soft = forward(img, tab)
    assert hard.shape == soft.shape == (4,) and hard.dtype == torch.float32
    assert torch.isfinite(hard).all() and torch.isfinite(soft).all()


if __name__ == "__main__":
    _rank_main(sys.argv[1], Path(sys.argv[2]))
