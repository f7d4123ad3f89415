"""Multi-rank dryrun (port of mmtrs_tpu/parallel/dryrun.py): the real
trainers data-parallel over an n-rank group, on tiny shapes.

- :func:`run` executes in one rank of a group (or, with ``group=None``, as
  the one process the group is held to) the JAX dryrun's three families:
  (1) data-parallel steps of the real ``MMTrainer(group=...)`` and its
  sharded ragged eval, with ``pad_to_multiple`` on a ragged batch; (2)
  ``preprocess_augment_batch`` sharded by batch, each rank on its
  contiguous shard with its lineages' ``legacy`` draws, gathered in rank
  order; (3) data-parallel steps of the real ``MILTrainer``. With
  ``rehearsal`` it adds the MM trainer at the rehearsal's widths (B4 at 380,
  bf16, ``randaug``, global batch 12). The families train in f32, so that a
  group's trajectory can be held to one process's.
- :func:`launch` starts n rank processes of a module, each with its rank,
  the world size, the backend, a fresh ``FileStore`` and its device in the
  environment (``parallel.mesh.group_from_env``); a rank that fails makes
  it stop the others and raise with that rank's stderr tail.
- :func:`spawn` launches this module's :func:`main` in n ranks; it is what
  ``graft_entry.dryrun_multichip`` runs.

Devices and backends are the caller's: ``device=None`` (the default) is the
card, as ``"cuda"`` is, and raises where no card is visible; ``"cuda"`` puts
rank r on card r mod the cards visible, over nccl (one card per rank, the
default backend there) or gloo (ranks may share a card); ``device="cpu"``
runs CPU processes (one torch thread each) over gloo, its default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.parallel import mesh

_REPO_ROOT = Path(__file__).resolve().parents[2]
STEPS = 3  # train steps of each family, as the JAX parity worker takes
AUG_SEED = 7  # keys_for_batch(7, arange(B), ones(B)) in the JAX dryrun
REHEARSAL_RAW = 512  # the rehearsal's raw image size, resized to 380 in the prep
ALL_REDUCE_REPS = 5


def _rank_devices(n: int, device: torch.device, backend: str) -> list[str]:
    dev = device
    if backend not in mesh.BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {mesh.BACKENDS}")
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("CPU ranks take the gloo backend")
        return ["cpu"] * n
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: cpu or cuda")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible")
    if backend == "nccl" and count < n:
        raise RuntimeError(f"nccl takes one card per rank: {n} ranks, {count} cards visible")
    return [f"cuda:{r % count}" for r in range(n)]


LAUNCH_GRACE_S = 5.0  # how long the other ranks get to exit after one fails


def launch(n: int, module: str, args=(), device: str | torch.device | None = None, backend: str | None = None,
           timeout: float = 3600.0, workdir: str | os.PathLike | None = None) -> list[str]:
    """Run ``python -m module *args`` in n rank processes of one group and
    wait for them; → each rank's stdout. A rank that exits non-zero stops
    the others, after LAUNCH_GRACE_S for them to exit, and raises with the
    stderr tail of every rank that failed; at the timeout, of every rank
    still running. The
    store and the ranks' logs live in a temporary folder (in ``workdir``
    when given), removed after. ``device`` None is the card (raising where
    none is visible); ``backend`` None is nccl on the card, gloo on the CPU."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    devices = _rank_devices(n, dev, backend)
    with tempfile.TemporaryDirectory(prefix="mmtrs_dist_", dir=workdir) as tmp:
        procs, outs, errs = [], [], []
        try:
            for r in range(n):
                env = dict(os.environ)
                env.update({mesh.ENV_RANK: str(r), mesh.ENV_WORLD: str(n), mesh.ENV_BACKEND: backend,
                            mesh.ENV_STORE: str(Path(tmp) / "store"), mesh.ENV_DEVICE: devices[r]})
                env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
                env.setdefault("NCCL_SOCKET_IFNAME", "lo")
                env["PYTHONPATH"] = str(_REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
                if devices[r] == "cpu":
                    env["OMP_NUM_THREADS"] = "1"
                outs.append(open(Path(tmp) / f"rank{r}.out", "w+"))
                errs.append(open(Path(tmp) / f"rank{r}.err", "w+"))
                procs.append(subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=str(_REPO_ROOT),
                                              env=env, stdout=outs[r], stderr=errs[r]))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            # a rank that fails takes its peers down (their collectives see the
            # closed connection), often within one poll: wait a moment for
            # them, so that the error shows every rank that failed, the cause
            # among them, whichever exited first
            grace = time.monotonic() + LAUNCH_GRACE_S
            while any(c not in (None, 0) for c in codes) and None in codes and time.monotonic() < grace:
                time.sleep(0.05)
                codes = [p.poll() for p in procs]
            # the ranks that failed, else (at the timeout) the ranks still running
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)] or \
                [r for r, c in enumerate(codes) if c is None]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for f in outs + errs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        stdout, stderr = texts[:n], texts[n:]
        if failed:
            raise RuntimeError("\n".join(f"rank {r} of {n} ({module}, {devices[r]}, {backend}) failed "
                                         f"(exit {procs[r].returncode}):\n{stderr[r][-4000:]}" for r in failed))
        return stdout


def _rng_batch(B: int, size: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (B, size, size, 3)).astype(np.float32), rng.normal(size=(B, 9)).astype(np.float32),
            rng.integers(0, 2, B).astype(np.float32))


def _mm_family(group, device, world: int, model_name: str) -> dict:
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.train.mm import MMTrainer

    B = 2 * world
    cfg = MMJointConfig(model_name=model_name, img_size=32, tab_hidden=8, batch_size=B, epochs=1,
                        train_aug="none")  # augmentation is family 2's
    trainer = MMTrainer(cfg, device=device, dtype=torch.float32, group=group)
    trainer.init_state(total_steps=STEPS)
    imgs, tab, y = _rng_batch(B + 1, cfg.img_size, 0)
    batch = {"img": trainer._prep(torch.from_numpy(imgs[:B]).to(device)), "tab": torch.from_numpy(tab[:B]).to(device),
             "y": torch.from_numpy(y[:B]).to(device), "p": torch.full((B,), 0.5, device=device)}
    if group is not None:
        batch = mesh.shard_batch(group, batch)
    losses = [trainer.train_step(batch["img"], batch["tab"], batch["y"], batch["p"]) for _ in range(STEPS)]
    logits = trainer.logits(torch.from_numpy(imgs).to(device), tab, tta=True)  # ragged: the pad path
    padded, real = mesh.pad_to_multiple(np.ones((B + 1, 3), np.float32), world)
    return {"mm_losses": [float(l) for l in losses], "mm_eval": logits,
            "pad_ok": bool(real == B + 1 and padded.shape[0] % world == 0)}


def _aug_family(group, device, world: int, size: int) -> dict:
    from mmtrs_tpu_torch.ops.augment import draw_legacy
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch

    B = 2 * world
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)).to(device)

    def chain(x, oids, aug):
        draws = draw_legacy(AUG_SEED, [int(o) for o in oids], [int(a) for a in aug], size, size, img_size=size)
        return preprocess_augment_batch(x, draws.to(device), out_size=size)[0]

    reset_launches()
    out = mesh.data_parallel_eval(group, chain, imgs, np.arange(B), np.ones(B, np.int64))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {f"aug{size}": out.cpu().numpy(), f"launches{size}": dict(LAUNCHES)}


def _mil_family(group, device, world: int) -> dict:
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.train.mil import MILTrainer

    B = 2 * world
    cfg = MILConfig(model_name="test_cnn", img_size=32, bag_size=2, batch_size=B, attn_dim=8, epochs=1)
    trainer = MILTrainer(cfg, device=device, dtype=torch.float32, group=group)
    trainer.init_state(total_steps=STEPS)
    imgs, _, y = _rng_batch(B + 1, 32, 2)
    imgs = torch.from_numpy(imgs.astype(np.uint8)).to(device)
    oid, y_d = np.arange(B), torch.from_numpy(y[:B]).to(device)
    rows = slice(None) if group is None else group.rows(B)
    bags = trainer.train_bags(imgs[:B][rows], 1, oid[rows])
    losses = [trainer.train_step(bags, y_d[rows]) for _ in range(STEPS)]
    probs = trainer.predict_proba(None, imgs, np.arange(B + 1))  # ragged: the pad path
    return {"mil_losses": [float(l) for l in losses], "mil_eval": probs}


def _rehearsal_family(group, device, world: int) -> dict:
    """The MM trainer at the rehearsal's widths: B4 at 380 in bf16, randaug
    on 512² teeth, the global batch 12 (split over the group), STEPS steps
    with the prep apart; the step's host ms (synchronised), the gradient
    all-reduce's ms (ALL_REDUCE_REPS calls on the step's gradients) and the
    peak device memory."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.mm import MMTrainer

    cfg = MMJointConfig()  # efficientnet_b4, 380, batch 12, randaug
    trainer = MMTrainer(cfg, device=device, group=group)
    trainer.init_state(total_steps=STEPS)
    syncs = 0 if group is None else group.grad_syncs
    B = cfg.batch_size
    imgs = torch.from_numpy(synth_teeth(B, REHEARSAL_RAW, seed=3)).to(device)
    _, tab, y = _rng_batch(B, 1, 4)
    sel = np.arange(B)
    rows = slice(None) if group is None else group.rows(B)
    tab_d, y_d = torch.from_numpy(tab).to(device)[rows], torch.from_numpy(y).to(device)[rows]
    p_d = torch.full((B,), 0.5, device=device)[rows]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    for step in range(STEPS):
        x = trainer._prep_train(imgs[rows], sel[rows], step)
        sync()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(x, tab_d, y_d, p_d))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": [float(l) for l in losses], "step_ms": step_ms,
           "params": sum(p.numel() for p in trainer.opt.params)}
    if group is not None:
        out["grad_syncs"] = group.grad_syncs - syncs
        times = []
        for _ in range(ALL_REDUCE_REPS):
            sync()
            t0 = time.perf_counter()
            mesh.all_reduce_grads_(trainer.opt.params, group)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_ms"] = times
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def run(group, device, world: int | None = None, model_name: str = "efficientnet_b0", aug_sizes=(64,),
        rehearsal: bool = False) -> dict:
    """The dryrun's families in this rank (``group``) or as the one process
    a group of ``world`` ranks is held to (``group=None``); → their losses,
    eval outputs and augmented batches (every rank ends with the gathered
    ones), the kernel launches of family 2 at each size, and with
    ``rehearsal`` the rehearsal-width MM steps."""
    device = torch.device(device)
    world = group.size if group is not None else world
    out = {"world": world, "rank": 0 if group is None else group.rank}
    out.update(_mm_family(group, device, world, model_name))
    for size in aug_sizes:
        out.update(_aug_family(group, device, world, size))
    out.update(_mil_family(group, device, world))
    if rehearsal:
        out["rehearsal"] = _rehearsal_family(group, device, world)
    return out


def save_result(res: dict, path: Path) -> None:
    """A run's result as ``path``.npz (its arrays) and ``path``.json (the rest)."""
    arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
    np.savez(path.with_suffix(".npz"), **arrays)
    path.with_suffix(".json").write_text(json.dumps({k: v for k, v in res.items() if k not in arrays}))


def load_result(path: Path) -> dict:
    res = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as z:
        res.update({k: z[k] for k in z.files})
    return res


def spawn(n: int, device: str | torch.device | None = None, backend: str | None = None, model_name: str = "efficientnet_b0",
          aug_sizes=(64,), rehearsal: bool = False, out: str | os.PathLike | None = None,
          timeout: float = 3600.0) -> list[str]:
    """Run the dryrun in n rank processes (:func:`launch`); with ``out`` each
    rank writes its result there as ``rank{r}.npz`` / ``.json``. Devices and
    backends default as :func:`launch`'s. Prints rank 0's output; → every
    rank's stdout."""
    args = ["--model_name", model_name, "--aug_sizes", ",".join(map(str, aug_sizes))]
    if rehearsal:
        args.append("--rehearsal")
    if out is not None:
        args += ["--out", str(out)]
    stdout = launch(n, "mmtrs_tpu_torch.parallel.dryrun", args, device=device, backend=backend, timeout=timeout)
    sys.stdout.write(stdout[0])
    return stdout


def main(argv=None) -> None:
    """A rank's entry (its group in the environment, ``launch``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_name", default="efficientnet_b0")
    ap.add_argument("--aug_sizes", default="64")
    ap.add_argument("--rehearsal", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    group, device = mesh.group_from_env()
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:  # f32 families in f32, not TF32, so a group's trajectory holds to one process's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = run(group, device, model_name=a.model_name, aug_sizes=[int(s) for s in a.aug_sizes.split(",")],
                  rehearsal=a.rehearsal)
        if a.out is not None:
            save_result(res, Path(a.out) / f"rank{group.rank}")
    finally:
        group.close()
    if group.rank == 0:
        B = 2 * group.size
        sizes = ", ".join(f"b{B}@{s} {'finite' if np.isfinite(res[f'aug{s}']).all() else 'NOT FINITE'}"
                          for s in a.aug_sizes.split(","))
        print(f"[dryrun] OK: {group.size}x {device.type} ranks over {group.backend}; families: "
              f"MM[{a.model_name}] DP steps (losses {', '.join(f'{l:.4f}' for l in res['mm_losses'])}), "
              f"preprocess+augment chain sharded {sizes}, MIL DP steps (loss {res['mil_losses'][-1]:.4f})",
              flush=True)


if __name__ == "__main__":
    main()
