"""Multi-process data parallelism on ``torch.distributed`` (port of
``cald_tpu/parallel/mesh.py``; reference detection/utils.py:75-142,302-324:
NCCL init, all_gather of pickles, reduce_dict).

Every process (rank) holds a full replica of the model and trains on its
stride of the data; a step's gradients are averaged over the ranks, so N
ranks with local batch B compute what one process computes on the
concatenated batch of N * B images (the JAX package's global batch). The
JAX package's mesh functions have no torch object; their roles move here and
into the driver:

  JAX (cald_tpu.parallel)          the port
  -----------------------          --------
  data_mesh, local_data_mesh,      none: a rank works on one device,
  batch_sharding                   ``cuda:LOCAL_RANK`` (``local_rank``)
  shard_batch, global_batch        the rank's loader stride (``process_shard``)
                                   and ``process_draw``; the detector's
                                   losses are per-image means, so averaging
                                   the ranks' gradients (``reduce_gradients_``)
                                   is the global batch's gradient
  replicate, global_replicate      ``broadcast_module_``: rank 0's weights,
                                   as DDP broadcasts them at wrap time
  to_host_local, host_gather       the identity: every rank holds the full
                                   replica, and tensors go to the host with
                                   ``.cpu()``

The helpers the JAX package shares with its driver keep their names and
rules: ``initialize_distributed``, ``process_count``, ``process_index``,
``process_shard``, ``all_gather_objects`` and ``process_merge_sum``; the last
three are exact identities at one process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(*, coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group of a multi-process launch (the reference's
    ``init_distributed_mode``).

    Activation, in order:
      * explicit arguments (tests and bespoke launchers), ``coordinator``
        being ``host:port`` or an init URL;
      * torchrun's environment: ``WORLD_SIZE`` above 1 with ``RANK``,
        ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``);
      * the JAX package's names, ``JAX_COORDINATOR_ADDRESS`` +
        ``JAX_NUM_PROCESSES`` + ``JAX_PROCESS_ID`` (``tcp://`` to the
        coordinator);
      * ``CALD_TPU_DISTRIBUTED=1``: ``env://``;
    anything else is a single-process no-op. Idempotent. The backend is NCCL
    when CUDA is available, else gloo; ``backend`` overrides it (two ranks
    sharing one card need gloo: NCCL refuses a duplicate GPU). Under NCCL the
    rank's current CUDA device is set to ``local_rank()``.

    Returns True when more than one process takes part.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world = num_processes or int(os.environ["JAX_NUM_PROCESSES"])
        rank = process_id if process_id is not None else int(os.environ["JAX_PROCESS_ID"])
    elif env_world > 1 or os.environ.get("CALD_TPU_DISTRIBUTED") == "1":
        init, world, rank = "env://", env_world, int(os.environ.get("RANK", "0"))
    else:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return world > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank(rank: int | None = None) -> int:
    """The rank's card on its host: ``LOCAL_RANK`` (torchrun), else the rank
    modulo the visible card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def _comm_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_shard(indices, *, pad: bool = True) -> np.ndarray:
    """This rank's strided slice of an index list (the DistributedSampler).
    With ``pad`` the list is first wrapped to a multiple of the process
    count, so every rank gets as many indices as the others."""
    idx = np.asarray(list(indices))
    p, n = process_count(), process_index()
    if p == 1:
        return idx
    if pad and len(idx) % p:
        idx = np.concatenate([idx, idx[: p - len(idx) % p]])
    return idx[n::p]


def all_gather_objects(obj) -> list:
    """One picklable object per rank; every rank receives the
    ``process_count()``-long list, in rank order (the reference's
    ``utils.all_gather``). Under NCCL the pickles travel as CUDA tensors on
    the rank's card."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def process_merge_sum(x) -> np.ndarray:
    """Element-wise sum of a host array over the ranks: the score merge
    (each rank scatters its shard's scores into a zero-filled full-length
    array; the sum is the global array, identical on every rank)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def process_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a tensor over the ranks (identity at one process): a
    logged per-rank mean becomes the global batch's."""
    if process_count() == 1:
        return t
    dev = t.device
    t = t.detach().to(_comm_device(), copy=True)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return (t / process_count()).to(dev)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Overwrite every parameter and buffer with rank ``src``'s (DDP's
    broadcast at wrap time, the JAX package's ``global_replicate``)."""
    if process_count() > 1:
        for t in module.state_dict().values():
            buf = t.detach().to(_comm_device())
            dist.broadcast(buf, src)
            t.detach().copy_(buf)
    return module


def reduce_gradients_(*optimizers: torch.optim.Optimizer) -> None:
    """Average the gradients of the optimizers' parameters over the ranks,
    in place, in one flat all-reduce per dtype (identity at one process).

    Only what an optimizer steps is reduced: frozen parameters
    (``requires_grad=False``, the ResNet stem and layer1) are in no
    optimizer. A parameter that the loss does not reach has no gradient on
    any rank (its use is structural, never data dependent) and is left
    without one, so the optimizer skips it as a single process does.
    """
    if process_count() == 1:
        return
    params = [p for opt in optimizers for g in opt.param_groups for p in g["params"]
              if p.grad is not None]
    comm = _comm_device()
    for dtype in sorted({p.grad.dtype for p in params}, key=str):
        group = [p for p in params if p.grad.dtype == dtype]
        flat = torch.cat([p.grad.reshape(-1) for p in group]).to(comm)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= process_count()
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def _gather(x: torch.Tensor) -> torch.Tensor:
    comm = _comm_device()
    parts = [torch.empty_like(x, device=comm) for _ in range(process_count())]
    dist.all_gather(parts, x.detach().to(comm).contiguous())
    return torch.cat(parts).to(x.device)


class _GatherCat(torch.autograd.Function):
    """``_gather``, whose backward sums the incoming gradients over the
    ranks (all_gather's adjoint) and hands each rank its own slice."""

    @staticmethod
    def forward(ctx, x):
        ctx.b, ctx.device = x.shape[0], x.device
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().to(_comm_device(), copy=True).contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        r = process_index()
        return g[r * ctx.b:(r + 1) * ctx.b].to(ctx.device)


def gather_cat(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank concatenated along dim 0 in rank order, so the
    rows are the global batch's (identity at one process). Differentiable:
    a loss computed alike on every rank from the result, with the gradients
    then averaged by ``reduce_gradients_``, gets the gradient of that loss."""
    if process_count() == 1:
        return x
    return _GatherCat.apply(x) if x.requires_grad else _gather(x)


def process_draw(draw):
    """A draw (``models.matcher.Draw`` or ``augment.suite.Draw``) that gives
    this rank its rows of the draw of the global batch: ``draw(i, (N * B,
    ...))``, rows ``rank * B`` to ``(rank + 1) * B``. The ranks then sample
    as one process does on the concatenated batch (identity at one
    process)."""
    n = process_count()
    if n == 1:
        return draw
    r = process_index()

    def sliced(i, shape, **kw):
        b = shape[0]
        return draw(i, (n * b, *shape[1:]), **kw)[r * b:(r + 1) * b]

    return sliced
