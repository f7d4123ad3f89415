"""The plain CPU versions of the LAB kernels give one answer under any
intra-op thread count: their exp and log run on the calling thread
(``ops.color.serial_cpu``). Each case runs in fresh interpreters, since a
split that went wrong once stayed wrong for the whole process."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# K2's backward conversion on the first 64 rows of every (L', a, b) triple,
# through K2's plain version with identity LUTs and through lab_bwd_ref,
# then K1's plain forward step twice on the same rows as RGB
SCRIPT = r"""
import hashlib, numpy as np, torch
from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_apply_lab_bwd_ref, lab_bwd_ref, lab_fwd_ref
i = np.arange(64 * 4096, dtype=np.uint32)
t = torch.from_numpy(np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8).reshape(1, 64, 4096, 3))
lq, da, db = (t[..., c].contiguous() for c in range(3))
da, db = da.view(torch.int8), db.view(torch.int8)
ident = torch.arange(256, dtype=torch.uint8).expand(1, 64, 256).contiguous()
a, b = clahe_apply_lab_bwd_ref(lq, da, db, ident, (8, 8)), lab_bwd_ref(lq, da, db)
f1, f2 = lab_fwd_ref(t), lab_fwd_ref(t)
same = torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(f1, f2))
digest = hashlib.md5(a.numpy().tobytes() + b"".join(x.numpy().tobytes() for x in f1)).hexdigest()
print(torch.get_num_threads(), same, digest)
"""

PROCESSES = 4


def _run(threads: str | None) -> tuple[int, str, str]:
    env = dict(os.environ)
    env.pop("OMP_NUM_THREADS", None)
    if threads is not None:
        env["OMP_NUM_THREADS"] = threads
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    n, same, digest = res.stdout.split()
    return int(n), same, digest


@pytest.fixture(scope="module")
def runs():
    """PROCESSES fresh interpreters at one thread and as many at the
    machine's default, run side by side."""
    settings = ["1"] * PROCESSES + [None] * PROCESSES
    with ThreadPoolExecutor(len(settings)) as pool:
        return dict(zip(range(len(settings)), pool.map(_run, settings))), settings


@pytest.mark.parametrize("which", ["one_thread", "default_threads"])
def test_plain_lab_versions_agree_in_every_process(runs, which):
    """Within each process the two plain K2 routes agree and K1's plain
    version repeats itself, at one thread and at the default count."""
    results, settings = runs
    want = "1" if which == "one_thread" else None
    mine = [results[i] for i, s in enumerate(settings) if s == want]
    assert all(same == "True" for _, same, _ in mine), mine
    if want == "1":
        assert all(n == 1 for n, _, _ in mine)


def test_plain_lab_versions_do_not_depend_on_the_thread_count(runs):
    """Every process, whatever its thread count, gives the same bytes."""
    results, _ = runs
    assert len({digest for _, _, digest in results.values()}) == 1, results
