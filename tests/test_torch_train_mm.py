"""The port's MM trainer held against the JAX package on the CPU in float32:
the optimiser (schedule, clip, AdamW chain), one train step of
MMJointDualHead("test_cnn") and of the B0 backbone, dropout and drop-path,
the temperature fit, the whole ``run_mm_kfold`` and its checkpoints read
back by both packages.

The JAX trainer builds its model in bf16; the slice tests swap in its f32
twin (``functools.partial(MMJointDualHead, dtype=float32)``) and give the
port the same Flax init, so both train the same network from the same
weights on the same batches (``epoch_batches`` draws the same numpy
permutations).

Some leaves have no gradient in exact arithmetic: a bias whose output
reaches the loss only through linear operations and then a train-mode
BatchNorm, which subtracts the batch mean again — the biases of TabMLP's
Dense layers, and in B0 every MBConv's last BatchNorm bias (its block's
output goes through residual sums and 1×1 convolutions into the next
BatchNorm; chip_smoke.py's ``_zero_grad_leaves`` states the rule for B4,
where one block convolves it depthwise with zero padding first). Both
packages compute those gradients as rounding noise (~1e-9 against
gradients of ~0.1), and AdamW's g / (√v + ε) turns that noise into steps of
up to ``lr``. The tests hold those leaves to that (both gradients ≤ 1e-6 of
the model's largest, the step within 2·lr) and every other leaf to the
stated bars. The noise also reaches the eval logits through the
BatchNorm running means, so after the slice's 2 epochs the OOF and test
probabilities agree within 1e-3 (measured 1.5e-4), not 1e-4.
"""

import functools
import json

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.synth import synth_images, synth_standardized

LR = 1e-3
NOISE_LEAVES = ("['params']['tab_mlp']['fc0']['bias']", "['params']['tab_mlp']['fc1']['bias']")


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_mm_f32():
    from mmtrs_tpu.models.mm_joint import MMJointDualHead

    return functools.partial(MMJointDualHead, dtype=jnp.float32)


# -- the optimiser --------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, 2, 7, 100])
def test_schedule_matches_optax(total):
    """The learning rate at every step count 0..total + 1 equals optax's
    warmup_cosine_decay_schedule as the JAX make_optimizer builds it
    (warmup 0), to 1e-7 relative."""
    from mmtrs_tpu_torch.train.common import warmup_cosine_lr

    lr = 3e-4
    sched = optax.warmup_cosine_decay_schedule(
        init_value=lr, peak_value=lr, warmup_steps=1, decay_steps=max(total, 2), end_value=lr * 1e-2)
    for c in range(total + 2):
        want = float(sched(jnp.asarray(c, jnp.int32)))
        got = warmup_cosine_lr(lr, total, c)
        assert abs(got - want) <= 1e-7 * want, (c, got, want)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    """clip_by_global_norm_ on both sides of the threshold: below it the
    gradients are untouched (bit for bit), above it they equal optax's
    g / ‖g‖ · max within 2e-7 relative."""
    from mmtrs_tpu_torch.train.common import clip_by_global_norm_

    rng = np.random.default_rng(0)
    grads = [(rng.normal(0, 1, s) * scale / 10).astype(np.float32) for s in ((3, 4), (7,), (2, 3, 5))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 1.0)
    assert (float(norm) < 1.0) == (scale < 1.0)
    for g, w, orig in zip(got, want, grads):
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), orig)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=0)


@pytest.mark.parametrize("grad_scale", [0.05, 5.0])
def test_adamw_chain_matches_optax(grad_scale):
    """Three steps of the port's chain (clip 1.0, AdamW lr 3e-4 wd 1e-4 on
    the cosine schedule over 7 steps) equal the JAX make_optimizer applied
    by optax to the same parameters and gradients, to 1e-6, with the clip
    idle and active."""
    from mmtrs_tpu.train.common import make_optimizer as jax_make_optimizer
    from mmtrs_tpu_torch.train.common import make_optimizer

    rng = np.random.default_rng(1)
    shapes = ((4, 3), (5,), (2, 2, 3))
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * grad_scale / 4).astype(np.float32) for s in shapes] for _ in range(3)]

    tx = jax_make_optimizer(3e-4, 1e-4, 7, grad_clip=1.0)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tp, 3e-4, 1e-4, 7, grad_clip=1.0)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert opt.count == 3


# -- one train step -------------------------------------------------------------------


def _batch(n, size, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (n, size, size, 3)).astype(np.float32)
    tab = rng.normal(0, 1, (n, 9)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    return img, tab, y, p


def test_mm_train_step_matches_jax():
    """MMJointDualHead("test_cnn") in f32, dropouts 0, the Flax init
    converted, one batch of 8 at 32²: loss within 1e-5 relative, every
    gradient within 1e-4 of its leaf's max |g|, the parameters after the
    AdamW step within 1e-5 and the BatchNorm statistics within 1e-6 (the
    two bias leaves before BatchNorm as the module docstring says)."""
    import mmtrs_tpu.train.mm as jmm
    from mmtrs_tpu.config import MMJointConfig as JaxCfg
    from mmtrs_tpu.train.common import bce_logits as jax_bce
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax, mm_joint_to_flax
    from mmtrs_tpu_torch.train.common import bce_logits
    from mmtrs_tpu_torch.train.mm import MMTrainer

    kw = dict(model_name="test_cnn", img_size=32, batch_size=8, lr=LR, train_aug="none",
              tab_dropout=0.0, head_dropout=0.0)
    img, tab, y, p = _batch(8, 32, seed=2)
    orig = jmm.MMJointDualHead
    jmm.MMJointDualHead = _flax_mm_f32()
    try:
        jt = jmm.MMTrainer(JaxCfg(**kw))
        st = jt.init_state(10)
    finally:
        jmm.MMJointDualHead = orig
    v0 = jax.tree.map(np.asarray, {"params": st.params, "batch_stats": st.batch_stats})

    def jloss(params):
        (lc, lr_), _ = jt.model.apply({"params": params, "batch_stats": st.batch_stats}, img, tab,
                                      train=True, mutable=["batch_stats"])
        return jax_bce(lc, y) + 0.3 * jax_bce(lr_, p)

    jgrads = _leaves({"params": jax.jit(jax.grad(jloss))(st.params)})
    st1, jl = jt._train_step(st, {"img": img, "tab": tab, "y": y, "p": p})
    want = _leaves(jax.tree.map(np.asarray, {"params": st1.params, "batch_stats": st1.batch_stats}))

    pt = MMTrainer(MMJointConfig(**kw), device="cpu", init=mm_joint_from_flax(v0), dtype=torch.float32)
    pt.init_state(10)
    probe = MMTrainer(MMJointConfig(**kw), device="cpu", init=mm_joint_from_flax(v0), dtype=torch.float32).model
    probe.train()
    lc, lr_ = probe(torch.from_numpy(img), torch.from_numpy(tab))
    (bce_logits(lc, torch.from_numpy(y)) + 0.3 * bce_logits(lr_, torch.from_numpy(p))).backward()
    pgrads = _leaves(mm_joint_to_flax({k: v.grad for k, v in probe.named_parameters()}))
    pl = pt.train_step(*(torch.from_numpy(a) for a in (img, tab, y, p)))
    got = _leaves(mm_joint_to_flax(pt.model.state_dict()))

    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    assert set(pgrads) == set(jgrads)
    for k, g in jgrads.items():
        if k in NOISE_LEAVES:
            assert np.abs(g).max() <= 1e-6 * gmax and np.abs(pgrads[k]).max() <= 1e-6 * gmax, k
        else:
            assert np.abs(pgrads[k] - g).max() <= 1e-4 * np.abs(g).max(), k
    assert set(got) == set(want)
    for k, w in want.items():
        if k in NOISE_LEAVES:
            assert np.abs(got[k] - w).max() <= 2 * LR, k
        elif "batch_stats" in k:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5, err_msg=k)


def test_efficientnet_b0_train_step_matches_jax():
    """The backbone alone: JAX's create_model("efficientnet_b0",
    num_classes=0, drop_path=0.0, dtype=f32) at 64², batch 4, loss
    mean(features · r) — loss within 1e-5 relative, every gradient (MBConv,
    SE, BatchNorm in train mode) within 3e-4 of its leaf's max |g|, the
    BatchNorm statistics within 1e-5 relative (+ 1e-6), and the parameters
    after one step of the chain (clip 1.0, AdamW 1e-3) within 1e-5 where
    both gradients exceed 1e-3 of their leaf's max, within 2·lr elsewhere.
    The
    bars are not test_cnn's 1e-4 and 1e-6: through 16 blocks the two
    packages' f32 convolutions drift apart, the backward most in the first
    blocks' small leaves (measured 1.2e-4 of the leaf's max in
    stage0_block0's SE, 5e-6 of the largest gradient), the forward up to
    2.7e-6 relative in bn_head's batch variance."""
    from mmtrs_tpu.models.backbones.factory import create_model as jax_create
    from mmtrs_tpu.train.common import make_optimizer as jax_make_optimizer
    from mmtrs_tpu_torch.models.backbones.factory import create_model
    from mmtrs_tpu_torch.models.convert import efficientnet_from_flax
    from mmtrs_tpu_torch.train.common import make_optimizer
    from tests.test_torch_models import _random_variables

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    r = rng.normal(0, 1, (1280,)).astype(np.float32)
    flax_net = jax_create("efficientnet_b0", num_classes=0, drop_path=0.0, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, _random_variables(flax_net, jnp.asarray(x), seed=3, train=False))

    def jloss(params):
        f, mut = flax_net.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
        return jnp.mean(f * r), mut

    (jl, mut), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    # the chain is elementwise but for the global norm, so it runs on the
    # leaves raveled into one vector (optax on ~250 leaves compiles for 10 s)
    flat_p, unravel = jax.flatten_util.ravel_pytree(v["params"])
    flat_g, _ = jax.flatten_util.ravel_pytree(jg)
    tx = jax_make_optimizer(LR, 1e-4, 10, grad_clip=1.0)
    upd, _ = tx.update(flat_g, tx.init(flat_p), flat_p)
    want_params = _leaves({"params": unravel(optax.apply_updates(flat_p, upd))})
    want_stats = _leaves({"batch_stats": mut["batch_stats"]})
    jgrads = _leaves({"params": jg})

    net = create_model("efficientnet_b0", num_classes=0, drop_path=0.0, dtype=torch.float32)
    net.load_state_dict(efficientnet_from_flax(v), strict=True)
    net.train()
    loss = torch.mean(net(torch.from_numpy(x)) * torch.from_numpy(r))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    back = lambda sd: _leaves({"params": _en_tree(sd)})
    pgrads = back({k: p.grad for k, p in net.named_parameters()})
    assert set(pgrads) == set(jgrads)
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        if _en_noise_leaf(k):
            assert np.abs(g).max() <= 1e-6 * gmax and np.abs(pgrads[k]).max() <= 1e-6 * gmax, k
        else:
            assert np.abs(pgrads[k] - g).max() <= 3e-4 * np.abs(g).max(), k
    stats = _leaves({"batch_stats": _en_tree(net.state_dict(), "batch_stats")})
    assert set(stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    make_optimizer(net.parameters(), LR, 1e-4, 10, grad_clip=1.0).step()
    got = back({k: p.detach() for k, p in net.named_parameters()})
    for k, w in want_params.items():
        # a first AdamW step moves each element by lr·g / (|g| + ε): where
        # |g| is small against its leaf, the gradients' agreement above no
        # longer pins the step, which may then differ by up to 2·lr
        g = np.minimum(np.abs(jgrads[k]), np.abs(pgrads[k]))
        firm = g > 1e-3 * np.abs(jgrads[k]).max()
        if _en_noise_leaf(k):
            firm[...] = False
        np.testing.assert_allclose(got[k][firm], w[firm], rtol=0, atol=1e-5, err_msg=k)
        assert np.abs(got[k] - w).max() <= 2 * LR, k


def _en_noise_leaf(key: str) -> bool:
    """Every MBConv's last BatchNorm bias in B0: its output reaches the loss
    only through residual sums, 1×1 convolutions and then a train-mode
    BatchNorm (the next block's, or bn_head), which subtracts it again."""
    return key.endswith("['bn2']['bias']")


def _en_tree(sd: dict, coll: str = "params") -> dict:
    """An EfficientNet state dict (port names) → the Flax collection's
    tree, through the MM converter's inverse under a ``backbone`` prefix."""
    from mmtrs_tpu_torch.models.convert import mm_joint_to_flax

    tree = mm_joint_to_flax({"backbone." + k: v for k, v in sd.items()})[coll]
    return tree["EfficientNet_0"]


# -- dropout and drop-path ------------------------------------------------------------


def test_dropout_and_drop_path_keep_and_scale():
    """dropout keeps each element, drop_path each sample, with probability
    1 − rate (within a binomial 4σ), kept values scaled by 1/keep; the
    same generator seed gives the same bits."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import drop_path, dropout

    rate, n = 0.2, 200_000
    keep = 1 - rate
    x = torch.ones(n)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - keep) <= 4 * np.sqrt(keep * rate / n)
    assert torch.all(y[kept] == 1.0 / keep)
    assert torch.equal(y, dropout(x, rate, torch.Generator().manual_seed(0)))

    xs = torch.ones(20_000, 3, 2, 2)
    z = drop_path(xs, rate, torch.Generator().manual_seed(1))
    per = z.reshape(len(z), -1)
    assert torch.all((per == 0).all(1) | (per == 1.0 / keep).all(1))  # per sample
    frac = float((per[:, 0] != 0).float().mean())
    assert abs(frac - keep) <= 4 * np.sqrt(keep * rate / len(z))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, rate, None)


def test_train_mode_loss_is_deterministic_per_seed():
    """MMJointDualHead("test_cnn") in train mode with its JAX rates
    (dropouts 0.2): the same generator seed gives a bit-identical loss,
    another seed another one; eval mode takes no generator."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.train.common import bce_logits

    img, tab, y, _ = _batch(8, 32, seed=4)
    net = lecun_init_(MMJointDualHead("test_cnn", dtype=torch.float32), torch.Generator().manual_seed(4))
    sd = {k: v.clone() for k, v in net.state_dict().items()}

    def loss(seed):
        net.load_state_dict(sd)
        net.train()
        lc, _ = net(torch.from_numpy(img), torch.from_numpy(tab), generator=torch.Generator().manual_seed(seed))
        return float(bce_logits(lc, torch.from_numpy(y)))

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)
    net.eval()
    with torch.no_grad():
        a = net(torch.from_numpy(img), torch.from_numpy(tab))[0]
    assert torch.isfinite(a).all()


def test_batchnorm_train_update_is_flax_not_torch():
    """Train mode: the output uses the batch mean and biased variance; the
    running statistics become 0.9·old + 0.1·batch with the biased variance
    (F.batch_norm's running update, unbiased and with its own momentum
    convention, gives other numbers); eval mode is unchanged by it."""
    from mmtrs_tpu_torch.models.backbones.efficientnet import BatchNorm

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(2, 3, (6, 4, 5, 5)).astype(np.float32))
    bn = BatchNorm(4)
    bn.running_mean.fill_(0.5)
    bn.running_var.fill_(2.0)
    bn.train()
    out = bn(x)
    xd = x.double().numpy()
    m, v = xd.mean(axis=(0, 2, 3)), xd.var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.9 * 0.5 + 0.1 * m, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * 2.0 + 0.1 * v, rtol=1e-6)
    want = (xd - m[None, :, None, None]) / np.sqrt(v[None, :, None, None] + 1e-3)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    ra_m, ra_v = torch.full((4,), 0.5), torch.full((4,), 2.0)
    torch.nn.functional.batch_norm(x, ra_m, ra_v, training=True, momentum=0.1)
    assert not np.allclose(ra_v.numpy(), bn.running_var.numpy(), rtol=1e-4)


# -- temperature ----------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 3.0, 0.3])
def test_temperature_matches_jax(scale):
    """T within 1e-4 relative of JAX's TemperatureScaler (50 LBFGS steps)
    on well calibrated (scale 1), overconfident (3) and underconfident
    (0.3) logits."""
    from mmtrs_tpu.models.linear import TemperatureScaler as JaxT
    from mmtrs_tpu_torch.models.linear import TemperatureScaler

    rng = np.random.default_rng(6)
    z = rng.normal(0, 2, 300)
    y = (rng.random(300) < 1 / (1 + np.exp(-z))).astype(float)
    want = JaxT().fit(z * scale, y).temperature
    got = TemperatureScaler().fit(z * scale, y).temperature
    assert abs(got - want) <= 1e-4 * want, (got, want)


# -- the slice: run_mm_kfold in both packages -----------------------------------------


KW = dict(model_name="test_cnn", img_size=32, batch_size=12, lr=LR, n_folds=2, epochs=2,
          train_aug="none", tab_dropout=0.0, head_dropout=0.0)


@pytest.fixture(scope="module")
def kfold_runs(tmp_path_factory):
    """run_mm_kfold on 60 synthetic cases (15 test) at 32², 2 folds, 2
    epochs, save_ckpts, in both packages from the same Flax init."""
    import mmtrs_tpu.train.mm as jmm
    from mmtrs_tpu.config import MMJointConfig as JaxCfg
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.train.mm import run_mm_kfold
    from mmtrs_tpu_torch.utils.table import Table

    n = 60
    df = synth_standardized(n, seed=4)
    df["split"] = ["test" if i >= 45 else "train" for i in range(n)]
    y = df["y_majority"].astype(int).to_numpy()
    imgs = synth_images(n, 32, seed=5, labels=y)
    jdir, pdir = tmp_path_factory.mktemp("jax_mm"), tmp_path_factory.mktemp("port_mm")
    flax_mm = _flax_mm_f32()
    orig = jmm.MMJointDualHead
    jmm.MMJointDualHead = flax_mm
    try:
        jout = jmm.run_mm_kfold(imgs, df, JaxCfg(**KW), outdir=jdir, epochs=2, save_ckpts=True,
                                log=lambda *a: None)
    finally:
        jmm.MMJointDualHead = orig
    net = flax_mm(model_name="test_cnn", tab_dropout=0.0, head_dropout=0.0)
    v = net.init(jax.random.key(JaxCfg().seed), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 9)), train=False)
    table = Table({c: df[c].to_numpy() for c in df.columns})
    pout = run_mm_kfold(imgs, table, MMJointConfig(**KW), outdir=pdir, epochs=2, save_ckpts=True,
                        log=lambda *a: None, device="cpu", init=mm_joint_from_flax(jax.tree.map(np.asarray, v)),
                        dtype=torch.float32)
    return {"jax": jout, "port": pout, "jdir": jdir, "pdir": pdir, "imgs": imgs, "table": table}


def test_run_mm_kfold_matches_jax(kfold_runs):
    """Per fold val_auc and thr equal, T within 1e-3 relative; OOF and test
    probabilities within 1e-3 (see the module docstring; measured 1.5e-4);
    summary.json with the same keys and values within those bars; the CSVs'
    columns and rows' names equal; metrics.jsonl one fold_done a fold."""
    from mmtrs_tpu_torch.utils.io import read_table
    from mmtrs_tpu_torch.utils.profiling import StructuredLogger

    j, p = kfold_runs["jax"], kfold_runs["port"]
    js, ps = j["summary"], p["summary"]
    assert len(js["folds"]) == len(ps["folds"]) == 2
    for a, b in zip(js["folds"], ps["folds"]):
        assert a["fold"] == b["fold"] and a["val_auc"] == b["val_auc"] and a["thr"] == b["thr"]
        assert abs(a["T"] - b["T"]) <= 1e-3 * a["T"]
    assert js["mean_val_auc"] == ps["mean_val_auc"]
    assert abs(js["test_auc"] - ps["test_auc"]) <= 1e-3
    for part in ("oof", "test"):
        np.testing.assert_array_equal(p[part]["image_name"], j[part]["image_name"].to_numpy())
        np.testing.assert_array_equal(p[part]["y"], j[part]["y"].to_numpy())
        np.testing.assert_allclose(p[part]["prob"], j[part]["prob"].to_numpy(), rtol=0, atol=1e-3)
    jd, pd_ = kfold_runs["jdir"], kfold_runs["pdir"]
    for name in ("oof_val.csv", "pred_test.csv"):
        assert (pd_ / name).read_text().splitlines()[0] == (jd / name).read_text().splitlines()[0]
        assert read_table(pd_ / name).columns == ["image_name", "y", "prob"]
    jsum, psum = (json.loads((d / "summary.json").read_text()) for d in (jd, pd_))
    assert set(jsum) == set(psum) and [set(f) for f in jsum["folds"]] == [set(f) for f in psum["folds"]]
    recs = StructuredLogger(pd_ / "metrics.jsonl").read()
    assert [r["event"] for r in recs] == ["fold_done"] * 2 and [r["fold"] for r in recs] == [0, 1]
    assert set(recs[0]) == {"ts", "event", "fold", "val_auc", "thr", "T"}
    for k in range(2):
        jr = json.loads((jd / f"mm_dualtask_fold{k}.recipe.json").read_text())
        pr = json.loads((pd_ / f"mm_dualtask_fold{k}.recipe.json").read_text())
        assert set(jr) == set(pr) and pr["fold"] == k and pr["img_size"] == 32
        np.testing.assert_allclose(pr["scaler_mean"], jr["scaler_mean"], rtol=1e-6)
        np.testing.assert_allclose(pr["scaler_scale"], jr["scaler_scale"], rtol=1e-6)


def test_fold_checkpoints_serve_in_both_packages(kfold_runs):
    """The saved folds read back by the port's MMEnsemble.from_folder (in
    f32) give trainer.predict_proba's p within 1e-6 on test images, and,
    read as Flax trees (load_npz_checkpoint), give JAX's
    MMJointDualHead.apply the port's logits within 1e-5."""
    from mmtrs_tpu.models.mm_joint import MMJointDualHead as FlaxMM
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.models.convert import mm_joint_from_flax
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.serve.ensembles import MMEnsemble
    from mmtrs_tpu_torch.train.mm import MMTrainer, StandardScaler
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint

    pdir, imgs, table = kfold_runs["pdir"], kfold_runs["imgs"], kfold_runs["table"]
    folds = kfold_runs["port"]["folds"]
    read = MMEnsemble.from_folder(pdir, device="cpu")
    ens = MMEnsemble(read.folds, MMJointDualHead("test_cnn", dtype=torch.float32), device="cpu")
    trainer = MMTrainer(MMJointConfig(**KW), device="cpu", dtype=torch.float32)
    from mmtrs_tpu_torch.data.features import BASE_FEATURES

    tab_raw = np.stack([table[c] for c in BASE_FEATURES], axis=1).astype(np.float32)[45:50]
    x = torch.from_numpy(imgs[45:50])
    want = np.mean([trainer.predict_proba(f, x, tab_raw) for f in folds], axis=0)
    got = np.array([ens.predict(imgs[45 + i].astype(np.float32), tab_raw[i].tolist()) for i in range(5)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    flax_net = FlaxMM(model_name="test_cnn", dtype=jnp.float32)
    rng = np.random.default_rng(7)
    img = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    tab = rng.normal(0, 1, (3, 9)).astype(np.float32)
    for k, f in enumerate(folds):
        tree, recipe = load_npz_checkpoint(pdir / f"mm_dualtask_fold{k}")
        assert recipe["T"] == f["T"] and recipe["thr"] == f["thr"]
        assert isinstance(f["scaler"], StandardScaler)
        want = flax_net.apply(tree, img, tab, train=False)
        net = MMJointDualHead("test_cnn", dtype=torch.float32).eval()
        net.load_state_dict(mm_joint_from_flax(tree), strict=True)
        with torch.no_grad():
            got = net(torch.from_numpy(img), torch.from_numpy(tab))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_randaug_changes_train_batches_not_eval():
    """The twin of tests/test_train.py's: cfg.train_aug "randaug" alters
    the train batch prep, the same per (seed, row, epoch) and another across
    epochs, while eval prep is untouched and "none" train prep is eval
    prep."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.train.mm import MMTrainer

    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (8, 32, 32, 3)).astype(np.uint8))
    sel = np.arange(8)
    kw = dict(model_name="test_cnn", img_size=32, batch_size=8)
    aug = MMTrainer(MMJointConfig(train_aug="randaug", **kw), device="cpu")
    off = MMTrainer(MMJointConfig(train_aug="none", **kw), device="cpu")
    a0, a0b = aug._prep_train(imgs, sel, 0), aug._prep_train(imgs, sel, 0)
    a1 = aug._prep_train(imgs, sel, 1)
    o = off._prep_train(imgs, sel, 0)
    ev_aug, ev_off = aug._prep(imgs), off._prep(imgs)
    assert torch.equal(a0, a0b)
    assert float((a0 - a1).abs().max()) > 1e-3
    assert float((a0 - o).abs().max()) > 1e-3
    assert torch.equal(ev_aug, ev_off)
    assert torch.equal(o, ev_off)
    assert torch.isfinite(a0).all()


def test_trainer_needs_a_card_by_default():
    """MMTrainer and run_mm_kfold take device=None as the card: here, with
    none, they raise instead of training on the CPU; a pretrained tree that
    does not fit the backbone raises too."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.train.mm import MMTrainer, run_mm_kfold
    from mmtrs_tpu_torch.utils.table import Table

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = MMJointConfig(model_name="test_cnn", img_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        MMTrainer(cfg)
    t = Table({"y_majority": [0, 1], "p_indirect": [0.1, 0.9], "split": ["train", "test"]})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mm_kfold(np.zeros((2, 32, 32, 3), np.uint8), _with_features(t), cfg)
    tr = MMTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="pretrained"):
        tr.init_state(1, pretrained={"conv0.weight": torch.zeros(1)})


def _with_features(t):
    from mmtrs_tpu_torch.data.features import BASE_FEATURES

    for c in BASE_FEATURES:
        t[c] = np.zeros(len(t))
    t["origin_id"] = np.arange(len(t))
    t["image_name"] = ["a.jpg", "b.jpg"]
    return t
