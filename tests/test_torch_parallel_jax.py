"""The port's MM trainer at 2 gloo ranks against the JAX package's
``MMTrainer(mesh=make_mesh(2))`` itself: ``test_cnn`` at 32², batch 16,
dropouts 0, both from the same Flax init (the JAX trainer's model patched to
f32, the port given the converted init), 3 steps on the batch whose shards'
statistics differ (tests/test_torch_parallel_train.py's ``_skewed``), then
the TTA logits of the 17-row ragged batch. The JAX run is a subprocess under
``mmtrs_tpu.parallel.dryrun.forced_cpu_env(2)``, as tests/test_parallel.py
runs its mesh; the bars are that test's: losses rtol 1e-3 / atol 5e-5, eval
within 2e-3.

``python -m tests.test_torch_parallel_jax jax <dir>`` is the JAX run and
``... port <dir>`` a port rank (``parallel.dryrun.launch``).
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_parallel_train import EVAL_BAR, LOSS_ATOL, LOSS_RTOL, STEPS, _skewed

ROOT = Path(__file__).resolve().parents[1]
KW = dict(model_name="test_cnn", img_size=32, batch_size=16, tab_hidden=8, train_aug="none",
          tab_dropout=0.0, head_dropout=0.0)


def _jax_trainer(mesh=None):
    """The JAX MMTrainer with its model in f32 and its state at init."""
    import jax.numpy as jnp

    import mmtrs_tpu.train.mm as jmm
    from mmtrs_tpu.config import MMJointConfig
    from mmtrs_tpu.models.mm_joint import MMJointDualHead

    orig = jmm.MMJointDualHead
    jmm.MMJointDualHead = functools.partial(MMJointDualHead, dtype=jnp.float32)
    try:
        trainer = jmm.MMTrainer(MMJointConfig(**KW), mesh=mesh)
        return trainer, trainer.init_state(STEPS)
    finally:
        jmm.MMJointDualHead = orig


def _jax_main(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from mmtrs_tpu.parallel.mesh import make_mesh

    trainer, state = _jax_trainer(make_mesh(2))
    imgs, tab, y, p, _ = _skewed(17, 16, 7)
    batch = {"img": trainer._prep(imgs[:16]), "tab": jnp.asarray(tab[:16]), "y": jnp.asarray(y[:16]),
             "p": jnp.asarray(p[:16])}
    losses = []
    for _ in range(STEPS):
        state, loss = trainer._train_step(state, batch)
        losses.append(float(loss))
    logits = trainer.logits(state, imgs, tab, tta=True)
    (out / "jax.json").write_text(json.dumps({"devices": jax.device_count(), "losses": losses,
                                              "eval": np.asarray(logits).tolist()}))


def _port_main(out: Path) -> None:
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.parallel.mesh import group_from_env, shard_batch
    from mmtrs_tpu_torch.train.mm import MMTrainer

    torch.set_num_threads(1)
    group, _ = group_from_env()
    try:
        init = torch.load(out / "init.pt", weights_only=True)
        tr = MMTrainer(MMJointConfig(**KW), device="cpu", init=init, dtype=torch.float32, group=group)
        tr.init_state(STEPS)
        imgs, tab, y, p, _ = _skewed(17, 16, 7)
        batch = shard_batch(group, [tr._prep(torch.from_numpy(imgs[:16])),
                                    *(torch.from_numpy(a[:16]) for a in (tab, y, p))])
        losses = [float(tr.train_step(*batch)) for _ in range(STEPS)]
        logits = tr.logits(torch.from_numpy(imgs), tab, tta=True)
    finally:
        group.close()
    (out / f"port{group.rank}.json").write_text(json.dumps({"losses": losses, "eval": logits.tolist()}))


def test_two_ranks_match_jax_two_device_mesh(tmp_path):
    import jax

    from mmtrs_tpu.parallel.dryrun import forced_cpu_env
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.parallel.dryrun import launch

    _, state = _jax_trainer()  # the mesh's init: model.init(key(cfg.seed)) on any device count
    v0 = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    torch.save(mm_joint_from_flax(v0), tmp_path / "init.pt")
    proc = subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel_jax", "jax", str(tmp_path)],
                            env=forced_cpu_env(2), cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        launch(2, "tests.test_torch_parallel_jax", ["port", tmp_path], device="cpu", timeout=300, workdir=tmp_path)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    want = json.loads((tmp_path / "jax.json").read_text())
    assert want["devices"] == 2
    for r in range(2):
        got = json.loads((tmp_path / f"port{r}.json").read_text())
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        diff = float(np.max(np.abs(np.array(got["eval"]) - np.array(want["eval"]))))
        assert diff < EVAL_BAR, diff
        assert len(got["eval"]) == 17


if __name__ == "__main__":
    {"jax": _jax_main, "port": _port_main}[sys.argv[1]](Path(sys.argv[2]))
