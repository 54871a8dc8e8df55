"""Data parallelism over ``torch.distributed``.

Port of ``stdd_tpu/parallel/mesh.py``. JAX shards one program over a device
mesh and lets XLA insert the collectives; here one process drives each card
(rank), every rank holds the whole model, and the collectives are written
out. What each JAX name became:

- ``make_mesh`` / ``data_sharding`` / ``replicated``: the process group (one
  rank per card) and :class:`DataParallel` ``(rank, world)``; the
  parameters are replicated by construction (every rank draws them from one
  seed or loads one checkpoint), the batch by :func:`local_rows`.
- ``shard_batch`` / ``global_batch_from_local``: :func:`local_rows` keeps
  rows ``[r·lb, (r+1)·lb)`` of a global batch of ``world·lb``; a rank that
  loaded only its own shard of the data feeds its local batch as it is.
- XLA's gradient all-reduce: :func:`average_gradients`, after
  ``torch.autograd.grad`` (DDP cannot wrap a step that calls it).
- Sync-BN, which GSPMD gives for free: :func:`sync_batch_stats`, the mean and
  biased variance over the global batch through a differentiable all-reduce
  (``nn.SyncBatchNorm`` runs on CUDA only). The models read the active
  :class:`DataParallel` from :func:`data_parallel`'s context, as does
  dropout (:func:`global_rand`), so a world-N step is the world-1 step on
  the same global batch.
- ``make_sharded_score_fn``: :func:`make_sharded_score_fn`; ``shard_map``'s
  gather of the probs is :func:`gather_rows`.
- ``init_distributed`` / ``process_shard``: :func:`init_distributed`,
  :func:`process_shard`.

Every collective is an ``all_reduce`` (a gather sums zero-padded slices; its
adjoint all-reduces the gradient and keeps the rank's slice), the one
collective that NCCL and gloo both carry on CPU and CUDA tensors alike, or
the trainer's ``barrier``. ``COLLECTIVES`` counts them by name.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import pickle
import socket
from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class DataParallel(NamedTuple):
    """This process's place in a data-parallel job (the default process
    group): ``rank`` of ``world`` ranks."""

    rank: int
    world: int


COLLECTIVES: Counter = Counter()
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("stdd_data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]):
    """Within this block the models' train-mode BN normalizes with the
    global batch's statistics and dropout draws its mask over the global
    batch, keeping this rank's rows; ``None`` suspends both (a caller that
    already gathered the global batch)."""
    token = _ACTIVE.set(dp)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_data_parallel() -> Optional[DataParallel]:
    """The :class:`DataParallel` of the enclosing :func:`data_parallel`
    block if it spans more than one rank, else None."""
    dp = _ACTIVE.get()
    return dp if dp is not None and dp.world > 1 else None


def all_reduce_(t: torch.Tensor, dp: DataParallel, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``dp``'s ranks (counted)."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=op)
    return t


def barrier(dp: DataParallel) -> None:
    """Wait for every rank (counted)."""
    COLLECTIVES["barrier"] += 1
    dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its adjoint sums the gradients over ranks."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return all_reduce_(x.clone(), dp)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.dp), None


class _GatherRows(torch.autograd.Function):
    """Concatenate every rank's rows in rank order; the adjoint is the
    reduce-scatter of the gradient (summed over ranks, this rank's slice)."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, n = dp, x.shape[0]
        buf = x.new_zeros((dp.world * n,) + tuple(x.shape[1:]))
        buf[dp.rank * n:(dp.rank + 1) * n] = x
        return all_reduce_(buf, dp)

    @staticmethod
    def backward(ctx, g):
        dp = ctx.dp
        n = g.shape[0] // dp.world
        g = all_reduce_(g.contiguous().clone(), dp)
        return g[dp.rank * n:(dp.rank + 1) * n], None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x, dp)


def gather_rows(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along dim 0 in rank order,
    on every rank; differentiable for floating ``x``."""
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8), dp).bool()
    return _GatherRows.apply(x, dp)


def local_rows(x, rank: int, world: int):
    """Rows ``[rank·lb, (rank+1)·lb)`` of a global batch of ``world·lb``
    (an array, a tensor, or a dict of them); a batch that does not divide
    raises."""
    if isinstance(x, dict):
        return {k: local_rows(v, rank, world) for k, v in x.items()}
    n = x.shape[0]
    if n % world:
        raise ValueError(f"batch {n} is not divisible by the world size {world}")
    lb = n // world
    return x[rank * lb:(rank + 1) * lb]


def global_rand(shape: Sequence[int], generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; inside a data-parallel
    block, this rank's rows of one draw over the global batch (``shape[0]``
    local rows), so every rank draws what a single process would."""
    dp = active_data_parallel()
    if dp is None:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0]
    full = torch.rand((n * dp.world,) + tuple(shape[1:]), generator=generator, device=device)
    return full[dp.rank * n:(dp.rank + 1) * n]


def sync_batch_stats(x: torch.Tensor, dp: DataParallel, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of an N C … tensor over every
    rank's batch, computed in ``dtype`` (two all-reduces: the sums and
    counts, then the squared deviations from the global mean), with the
    gradient flowing through both."""
    dims = [0] + list(range(2, x.dim()))
    xf = x.to(dtype)
    count = xf.new_full((1,), x.numel() // x.shape[1])
    s = all_reduce_sum(torch.cat([xf.sum(dims), count]), dp)
    n = s[-1].detach()
    mean = s[:-1] / n
    view = (1, -1) + (1,) * (x.dim() - 2)
    d = xf - mean.view(view)
    var = all_reduce_sum((d * d).sum(dims), dp) / n
    return mean, var


def average_gradients(grads: Dict[str, torch.Tensor], dp: DataParallel) -> Dict[str, torch.Tensor]:
    """The mean over ranks of each rank's gradient tree, through one
    all-reduce of the flattened tree."""
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    all_reduce_(flat, dp).div_(dp.world)
    out, i = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[i:i + n].view_as(grads[k])
        i += n
    return out


def mean_over_ranks(xs: Sequence[torch.Tensor], dp: Optional[DataParallel]
                    ) -> Tuple[torch.Tensor, ...]:
    """The means over the ranks of scalar metrics ``xs`` (through one
    all-reduce, in the first one's dtype); ``xs`` themselves at world 1."""
    if dp is None or dp.world == 1:
        return tuple(xs)
    buf = torch.stack([x.detach().to(xs[0].dtype) for x in xs])
    return tuple(all_reduce_(buf, dp).div_(dp.world).unbind())


# -- joining a job ---------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost for a job's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda") -> Tuple[int, int]:
    """Join a data-parallel job and return ``(rank, world)``.

    ``coordinator`` ``host:port`` with ``num_processes`` and ``process_id``
    rendezvous at ``tcp://{coordinator}``; without them, torchrun's
    ``env://`` variables name the job (as JAX reads a pod's metadata). The
    backend is NCCL on ``cuda`` when every rank has a card of its own, and
    gloo otherwise: on the CPU, and on ``cuda`` with more ranks on this host
    (``LOCAL_WORLD_SIZE``, which torchrun sets, else the whole job) than
    visible cards (NCCL refuses two ranks on one card; gloo carries the
    CUDA tensors). On ``cuda`` each rank takes ``cuda:{local_rank}``
    (:func:`local_device`). A process already in a job keeps it, if it is
    the one asked for."""
    dev = torch.device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if (num_processes is not None and num_processes != world) or \
                (process_id is not None and process_id != rank):
            raise ValueError(f"this process is rank {rank} of {world} already")
        return rank, world
    if coordinator is not None and (num_processes is None or process_id is None):
        raise ValueError("--coordinator needs --num_processes and --process_id")
    world = num_processes if coordinator is not None else int(os.environ.get("WORLD_SIZE", 1))
    host_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    kw = {}
    if dev.type == "cuda":
        if coordinator is not None and "LOCAL_RANK" not in os.environ:
            os.environ["LOCAL_RANK"] = str(process_id)
        torch.cuda.set_device(local_device(dev))
        if host_ranks <= torch.cuda.device_count():
            backend, kw["device_id"] = "nccl", local_device(dev)
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, **kw)
    else:
        dist.init_process_group(backend, init_method="env://", **kw)
    return dist.get_rank(), dist.get_world_size()


def local_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (else the rank) modulo the
    visible cards on ``cuda`` (ranks beyond the cards share them), the CPU
    otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def _rank_main(rank: int, fn: Callable, world: int, port: int, device: str,
               threads: int, out_dir: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    init_distributed(f"127.0.0.1:{port}", world, rank, device)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world: int, args: tuple = (), device: str = "cuda") -> list:
    """Run ``fn(*args)`` in ``world`` new processes, each a rank of one job
    on localhost (``fn`` must be importable: the processes are spawned),
    sharing this process's torch threads; the job joins on ``device`` (the
    card unless the caller asks for the CPU). Returns what ``fn`` returned on
    each rank (picklable, in rank order); raises if any rank fails."""
    import tempfile

    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(fn, world, free_port(), device, threads, out_dir, args),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def process_shard(items: Sequence, rank: int, world: int) -> list:
    """This process's stripe of a work list: item ``i`` belongs to rank
    ``i % world`` (disjoint, near-equal, whose union is the list). Call it
    after any global shuffle, which every rank makes with the same seed."""
    if not (0 <= rank < world):
        raise ValueError(f"process_index {rank} out of range for count {world}")
    return list(items[rank::world])


# -- sharded serving -------------------------------------------------------------

def make_sharded_score_fn(scorer, dp: DataParallel) -> Callable:
    """Data-parallel serving: ``score(crops, boxes, lm5, valid) -> probs
    [B]`` on every rank, where each rank runs the scorer's fused
    align+score (K1, the I3D, K2 with ``fused_s2``) on its rows of the batch
    and the probs come back whole through :func:`gather_rows`. ``B`` must be
    a multiple of the world size. The scorer's weights are read at each
    call, so a checkpoint loaded into it takes effect at once."""

    def score(crops, boxes, lm5, valid) -> np.ndarray:
        B = len(crops)
        if B % dp.world:
            raise ValueError(f"batch {B} is not divisible by the world size {dp.world}")
        rows = [local_rows(a, dp.rank, dp.world) for a in (crops, boxes, lm5, np.asarray(valid))]
        probs = scorer.score_device(*rows)
        with torch.inference_mode():
            return gather_rows(probs, dp).cpu().numpy()

    return score
