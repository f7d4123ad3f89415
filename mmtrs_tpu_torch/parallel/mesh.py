"""The 1-D data group (port of mmtrs_tpu/parallel/mesh.py) over
``torch.distributed``.

The JAX mesh is global-view: ``data_parallel_jit`` jits the one-device
step over a batch-sharded array, so XLA computes the same function as one
device and inserts the all-reduces. A torch rank computes its own shard's
function, so the port adds each cross-rank term itself, and a step of n
ranks computes what one process computes on the whole batch:

- train-mode BatchNorm sums Σx and Σx² over the group, the gradient
  flowing back through the sum (``DataGroup.all_sum``; the trainers run
  their forward under ``sharded(group)``, which
  ``models/backbones/efficientnet.BatchNorm`` reads);
- a loss normalised by a weight sum sums Σw over the group first
  (``train.common.bce_logits``, the k-fold trainer's pos-weight BCE), and
  returns this rank's term, ``size · Σ_rank l·w / Σ_group w``, whose mean
  over the ranks is the global loss;
- dropout and drop-path masks are drawn at the global batch's shape from
  the same generator state on every rank, which keeps its own rows
  (``efficientnet._keep_mask``);
- gradients are averaged over the ranks after backward, in flat buckets,
  before the optimiser's global-norm clip (``all_reduce_grads_``);
- the start is broadcast from rank 0 (``replicate``), and evaluation
  scores each rank's contiguous shard of the padded batch and gathers the
  outputs in rank order (``data_parallel_eval``).

Every rank holds the whole dataset and runs the same host code (samplers,
draws, epochs, metrics); only the device work is divided. Of a global batch
of ``size · b`` rows, a rank takes the contiguous rows ``[rank · b, (rank +
1) · b)`` (``DataGroup.rows``). The trainers' ragged-batch pads repeat the
last row as JAX's do; ``pad_to_multiple`` repeats row 0 as JAX's does.

The backend is always the caller's: ``gloo`` for CPU processes and for
ranks that share one card, ``nccl`` for one card per rank. Gloo's
``all_gather`` on CUDA tensors is not documented, so outputs are gathered
through an ``all_reduce`` of a zeroed buffer. Rendezvous goes through a
``FileStore``, so concurrent groups on one machine never race for a port.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
BUCKET_BYTES = 25 * 2**20  # a flat gradient bucket, as DDP's default
# the environment of a rank process that ``parallel.dryrun.launch`` starts
ENV_RANK, ENV_WORLD = "RANK", "WORLD_SIZE"
ENV_BACKEND, ENV_STORE, ENV_DEVICE = "MMTRS_DIST_BACKEND", "MMTRS_DIST_STORE", "MMTRS_DIST_DEVICE"


class _AllSum(torch.autograd.Function):
    """Σ over the group, whose backward is the Σ of the ranks' upstream
    gradients: rank r then holds ∂(Σ_s L_s)/∂x_r."""

    @staticmethod
    def forward(ctx, pg, t):
        ctx.pg = pg
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllSum.apply(ctx.pg, grad)


@dataclass(eq=False)
class DataGroup:
    """This process's place in a 1-D data group: the process group, its
    rank, the world size and the backend. ``grad_syncs`` counts the
    gradient all-reduces (``all_reduce_grads_`` calls)."""

    pg: Any
    rank: int
    size: int
    backend: str
    grad_syncs: int = 0

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of ``t`` over the ranks, differentiable."""
        return _AllSum.apply(self.pg, t)

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def close(self) -> None:
        dist.destroy_process_group(self.pg)


def make_group(n: int, rank: int, backend: str, store: str | os.PathLike,
               device: str | torch.device | None = None) -> DataGroup:
    """Join the n-rank data group as ``rank`` over ``backend`` (gloo or
    nccl); the ranks meet at the ``FileStore`` file ``store`` (a fresh path
    for each group). NCCL takes one card per rank: ``device`` is the rank's
    card, made current."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if device is None or torch.device(device).type != "cuda":
            raise ValueError(f"nccl needs the rank's CUDA device, got {device!r}")
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, store=dist.FileStore(str(store), n), rank=rank, world_size=n)
    return DataGroup(dist.group.WORLD, rank, n, backend)


def group_from_env() -> tuple[DataGroup, torch.device]:
    """The group and device of a rank process that ``parallel.dryrun.launch``
    started (its rank, world size, backend, store and device are in the
    environment)."""
    env = os.environ
    device = torch.device(env[ENV_DEVICE])
    group = make_group(int(env[ENV_WORLD]), int(env[ENV_RANK]), env[ENV_BACKEND], env[ENV_STORE], device)
    return group, device


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mmtrs_data_group", default=None)


def active_group() -> DataGroup | None:
    """The group of the enclosing ``sharded`` block, else None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(group: DataGroup | None):
    """Within the block, train-mode BatchNorm takes its statistics over
    ``group`` and dropout/drop-path masks are this rank's rows of the global
    batch's; with None nothing changes."""
    if group is None:
        yield
        return
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad axis 0 to a multiple of the group's size; returns (padded,
    real_count). The pad rows replicate row 0 and are cut off downstream by
    the caller using real_count (JAX's semantics; a tensor is padded on its
    device)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    if isinstance(arr, torch.Tensor):
        pad = arr.index_select(axis, torch.zeros(rem, dtype=torch.long, device=arr.device))
        return torch.cat([arr, pad], dim=axis), n
    pad_idx = np.zeros(rem, dtype=np.int64)
    pad = np.take(arr, pad_idx, axis=axis)
    return np.concatenate([arr, pad], axis=axis), n


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(group: DataGroup, tree: Any) -> Any:
    """This rank's contiguous rows of axis 0 of every leaf (tensor or numpy
    array) whose axis 0 is a multiple of the group's size (at least it);
    other leaves (scalars, small side inputs) are kept whole, JAX's
    ``put_leaf`` rule. A side input whose axis 0 does split (class weights
    [2] over 2 ranks) would be cut, so the trainers pass theirs apart."""

    def leaf(x):
        n = x.shape[0] if getattr(x, "ndim", 0) >= 1 else 0
        return x[group.rows(n)] if n >= group.size and n % group.size == 0 else x

    return _map(leaf, tree)


@torch.no_grad()
def _flat_collective(tensors: list[torch.Tensor], op) -> None:
    """``op`` (in place) on the tensors through flat buffers of one dtype and
    at most BUCKET_BYTES each, in order, the results copied back."""
    bucket: list[torch.Tensor] = []
    nbytes = 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        torch._foreach_copy_(bucket, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in bucket]), bucket)])

    for t in tensors:
        size = t.numel() * t.element_size()
        if bucket and (nbytes + size > BUCKET_BYTES or t.dtype != bucket[0].dtype or t.device != bucket[0].device):
            flush()
            bucket, nbytes = [], 0
        bucket.append(t)
        nbytes += size
    if bucket:
        flush()


def all_reduce_grads_(params, group: DataGroup, stats: torch.Tensor | None = None) -> torch.Tensor | None:
    """Average the gradients of ``params`` (those that have one) over the
    group in place, one ``all_reduce`` a flat bucket; one gradient sync
    (``group.grad_syncs``). ``stats``, a small f32 tensor, rides along in
    the first bucket and is averaged in place too; → ``stats``."""
    tensors = [p.grad for p in params if p.grad is not None]
    if stats is not None:
        tensors.insert(0, stats)

    def mean_(flat):
        dist.all_reduce(flat, group=group.pg)
        flat.div_(group.size)

    _flat_collective(tensors, mean_)
    group.grad_syncs += 1
    return stats


@torch.no_grad()
def all_mean_(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """``t`` averaged over the ranks, in place (a statistic, not a gradient)."""
    dist.all_reduce(t, group=group.pg)
    return t.div_(group.size)


def replicate(group: DataGroup, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place (JAX's ``replicate`` puts a state on every device); → ``module``."""
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0, group=group.pg))
    return module


def _gather_rows(group: DataGroup, out: torch.Tensor, n: int) -> torch.Tensor:
    """The ranks' outputs [n / size, ...] → [n, ...] in rank order on every
    rank: each writes its rows into a zeroed buffer, summed over the group
    (x + 0 is x). Half-precision floats travel as f32."""
    wire = torch.float32 if out.dtype in (torch.float16, torch.bfloat16) else out.dtype
    buf = torch.zeros((n,) + tuple(out.shape[1:]), dtype=wire, device=out.device)
    buf[group.rows(n)] = out.detach().to(wire)
    dist.all_reduce(buf, group=group.pg)
    return buf.to(out.dtype)


@torch.no_grad()
def data_parallel_eval(group: DataGroup | None, fn, *args):
    """``fn(*args)`` over the group (the counterpart of
    ``data_parallel_eval_jit``): each arg's axis 0 padded to a multiple of
    the size (``pad_to_multiple``, row 0 repeated), each rank runs ``fn`` on
    its contiguous shard, and the outputs (a tensor or a tuple of them,
    axis 0 the batch) are gathered in rank order on every rank, the pad cut
    off. With None, ``fn(*args)``."""
    if group is None:
        return fn(*args)
    n = args[0].shape[0]
    padded = [pad_to_multiple(a, group.size)[0] for a in args]
    total = padded[0].shape[0]
    out = fn(*shard_batch(group, padded))
    return _map(lambda o: _gather_rows(group, o, total)[:n], out)
