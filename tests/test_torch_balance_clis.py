"""The port's augmentation CLIs (``python -m mmtrs_tpu_torch.cli.run_augment``
and ``...run_augment_simple``) held against the JAX package's
run_augment.py and run_augment_simple.py on the CPU.

The lineages: the JAX CLIs seed a source from ``hash(stem)``, which Python
salts per process, and the port from ``stem_id(stem)`` (CRC-32). Here the
JAX CLI's module global ``hash`` is set to ``stem_id``, so both take the
same lineage ids. The draws: threefry cannot be repeated by the port's
generators, so the port's ``draw_batch`` is replaced by one that builds the
preset's draws from JAX's own keys (``keys_for_batch(seed, [id], [k])``)
through the ``*Draws.from_numpy`` hooks, and JAX's normals are fed to
``seeded_normals`` (``ten``/``simple`` noise). Both CLIs feed the preset f32
(``run_augment.py:70``, ``run_augment_simple.py:52``); the JAX side runs
its TPU route with the Pallas kernels in interpret mode.

Bars: the tables byte for byte; the originals' JPEGs byte for byte; each
child's decoded pixels (JPEG q95 of the f32 chains) within 2 levels on 95 %
of values and 8 at most. Read: most children equal; the worst a ``legacy``
child at 95.9 % within 2, max 6 (its CLAHE member amplifies a level of the
f32 warp, ROADMAP Queue 3) and a ``simple`` noise child at 97.7 %, max 5."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from tests.test_torch_augment import jax_tpu_route  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 64
CHILD_BAR, CHILD_SHARE, CHILD_MAX = 2, 0.95, 8


def _jax_cli(name: str):
    from mmtrs_tpu_torch.utils.rng import stem_id

    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.hash = lambda s: stem_id(s)  # the JAX CLI's lineage ids, made stable
    return mod


def _jax_draws_for(preset: str, seed: int, origins, aug_idxs, variants, H: int, W: int, img_size: int):
    """The port's draws for ``preset`` built from JAX's keys, and JAX's
    noise normals for ``ten``/``simple``."""
    from mmtrs_tpu.utils.rng import keys_for_batch
    from tests.test_torch_augment import _jax_draws
    from tests.test_torch_presets import _jax_simple_draws, _jax_ten_draws

    keys = keys_for_batch(seed, jnp.asarray(origins, jnp.uint32), jnp.asarray(aug_idxs, jnp.uint32))
    if preset == "legacy":
        return _jax_draws(keys, H, W, hole=max(1, img_size // 24))[0], None
    return (_jax_ten_draws if preset == "ten" else _jax_simple_draws)(keys, np.asarray(variants) % 10, H, W)


@pytest.fixture
def jax_draws(monkeypatch):
    """Patch a port CLI module's ``draw_batch`` to JAX's draws."""
    import mmtrs_tpu_torch.ops.augment as ta

    normals = {}
    monkeypatch.setattr(ta, "seeded_normals", lambda seeds, shape: torch.from_numpy(normals["now"][seeds.long().numpy()]))

    def use(mod):
        def fake(preset, seed, origins, aug_idxs, H, W, aug_idx=None, img_size=512):
            draws, nrm = _jax_draws_for(preset, seed, origins, aug_idxs, aug_idx, H, W, img_size)
            normals["now"] = nrm
            return draws

        monkeypatch.setattr(mod, "draw_batch", fake)

    return use


def _teeth_dir(path: Path, n: int = 4) -> Path:
    from mmtrs_tpu_torch.synth import synth_teeth

    path.mkdir()
    for i in range(n):
        size = (SIZE, SIZE) if i != 1 else (SIZE + 16, SIZE + 8)  # one resized by both CLIs
        Image.fromarray(synth_teeth(1, size, seed=40 + i)[0]).save(path / f"t{i}.jpg", quality=95)
    return path


def _close(a: Path, b: Path):
    x = np.asarray(Image.open(a)).astype(int)
    y = np.asarray(Image.open(b)).astype(int)
    d = np.abs(x - y)
    return (d <= CHILD_BAR).mean(), int(d.max())


@pytest.mark.parametrize("strength", ["strong", "medium", "light"])
def test_run_augment_matches_jax(tmp_path, jax_tpu_route, jax_draws, strength):  # noqa: F811
    from mmtrs_tpu_torch.cli import run_augment as port

    src = _teeth_dir(tmp_path / "in")
    pd.DataFrame({"image_name": [f"t{i}.jpg" for i in range(4)] + ["gone.jpg"], "y_majority": [0, 1, 0, 0, 1],
                  "w": [0.5, 1.0, 1.5, 2.0, 2.5]}).to_csv(tmp_path / "t.csv", index=False)
    args = ["--table", str(tmp_path / "t.csv"), "--image_dir", str(src), "--target_per_class", "6",
            "--strength", strength, "--seed", "5", "--img_size", str(SIZE)]
    assert _jax_cli("run_augment").main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    jax_draws(port)
    assert port.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    j, p = tmp_path / "jax", tmp_path / "port"
    assert (p / "data_balanced.csv").read_bytes() == (j / "data_balanced.csv").read_bytes()
    names = sorted(q.name for q in (j / "images").iterdir())
    assert names == sorted(q.name for q in (p / "images").iterdir())
    readings = {}
    for n in names:
        if "_bal" not in n:
            assert (p / "images" / n).read_bytes() == (j / "images" / n).read_bytes(), n
            continue
        readings[n] = _close(p / "images" / n, j / "images" / n)
    assert readings and all(s >= CHILD_SHARE and m <= CHILD_MAX for s, m in readings.values()), readings


def test_run_augment_simple_matches_jax(tmp_path, jax_tpu_route, jax_draws):  # noqa: F811
    from mmtrs_tpu_torch.cli import run_augment_simple as port

    src = _teeth_dir(tmp_path / "in", 3)
    args = ["--input_dir", str(src), "--n", "11", "--seed", "3", "--img_size", str(SIZE), "--copy_originals"]
    assert _jax_cli("run_augment_simple").main(args + ["--output_dir", str(tmp_path / "jax")]) == 0
    jax_draws(port)
    assert port.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    j, p = tmp_path / "jax", tmp_path / "port"
    names = sorted(q.name for q in j.iterdir())
    assert names == sorted(q.name for q in p.iterdir()) and len(names) == 3 * 12
    readings = {n: _close(p / n, j / n) for n in names if "_" in n}
    for n in names:
        if "_" not in n:
            assert (p / n).read_bytes() == (j / n).read_bytes(), n
    assert all(s >= CHILD_SHARE and m <= CHILD_MAX for s, m in readings.values()), readings


def test_stem_id_is_stable_and_in_range():
    """The port's lineage id: the same in every process (a CRC-32), below 2³¹."""
    import zlib

    from mmtrs_tpu_torch.utils.rng import stem_id

    for s in ("t0", "case_0001", "ñandú", ""):
        assert stem_id(s) == zlib.crc32(s.encode()) % 2**31 < 2**31


def test_run_augment_draws_its_own_lineages(tmp_path):
    """Unpatched, the port's CLI is deterministic: two runs write the same
    bytes, and a child differs from its source."""
    from mmtrs_tpu_torch.cli import run_augment

    src = _teeth_dir(tmp_path / "in", 2)
    pd.DataFrame({"image_name": ["t0.jpg", "t1.jpg"], "y_majority": [0, 1]}).to_csv(tmp_path / "t.csv", index=False)
    for out in ("a", "b"):
        assert run_augment.main(["--table", str(tmp_path / "t.csv"), "--image_dir", str(src), "--out_dir",
                                 str(tmp_path / out), "--target_per_class", "3", "--strength", "strong",
                                 "--img_size", str(SIZE), "--device", "cpu"]) == 0
    names = sorted(q.name for q in (tmp_path / "a" / "images").iterdir())
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "a" / "images" / n).read_bytes() == (tmp_path / "b" / "images" / n).read_bytes()
    assert (tmp_path / "a" / "images" / "t0_bal1.jpg").read_bytes() != (tmp_path / "a" / "images" / "t0.jpg").read_bytes()
