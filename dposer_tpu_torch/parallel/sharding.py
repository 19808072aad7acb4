"""Several devices: a device mesh of the port's own, the row split of the
sharded kernel wrappers, multi-process evaluation, and data-parallel
training over a process group.

Port of ``dposer_tpu/parallel/sharding.py``. JAX shards
a batch over a ``jax.sharding.Mesh`` and runs each single-device Pallas
kernel once per shard under ``shard_map``: the rows split, the PRNG key is
folded by the shard's index, no collective runs, and the result is joined.
Here a ``Mesh`` is an ordered list of ``torch.device``s, one per shard, and
a sharded wrapper is one process that builds a single-device builder per
shard on that shard's device, launches the shards in order from one thread
(on distinct devices they overlap) and joins their rows on the mesh's first
device. A device may appear more than once: ``["cpu"] * 8`` is the
counterpart of JAX's virtual 8-device CPU mesh, ``["cuda:0"] * 4`` four
shards on one card.

Seeds: the caller's generator yields one 64-bit draw, and shard ``r`` gets
a ``torch.Generator`` on its device seeded with ``fold_seed(draw, r)``, a
splitmix64 output (the counterpart of ``fold_in(key, axis_index)``; it does
not reproduce JAX's bits). Every draw of the shard comes from it: the prior,
host normals, the seed of in-kernel normals, the Hutchinson probe.

Multi-process evaluation runs ``torch.distributed`` over gloo on CPU
tensors (``init_distributed``), the counterpart of
``jax.distributed.initialize``: each process evaluates its contiguous range
of batches (``shard_eval_batches``) and the per-sample results are gathered
(``allgather_ragged_1d``).

Data-parallel training is one process a device, PyTorch's idiom, where JAX
runs one GSPMD program over a global mesh: each process holds the whole
train state and steps on its contiguous rows of every global batch
(``shard_global_batch``); ``data_parallel_step`` runs the step with its row
range, so that its draws (``t``, ``z``, the dropout factors or the kernels'
hash rows) are the global batch's, as GSPMD draws them from a replicated key,
and with one all-reduce of the gradients and the losses between the
backward and the update (``allreduce_mean_``). Each rank's loss is the mean
over its own rows and the all-reduce averages them over the ranks: the
global batch's mean, exactly so up to the order of the sums when the ranks
hold equal rows. Clipping, Adam, the EMA and the step count then run on
identical gradients on every rank, so the ranks' states stay equal bit for
bit. The all-reduce runs on NCCL where each process of a host has a card of
its own, else on gloo, which stages CUDA tensors through the host
(``init_distributed(backend=)``); the gathers of CPU tensors always run on
gloo.

``data_parallel_sampler_params`` and ``multi_hypothesis_imputation_sampler_
params`` run a kernel sampler built once on weights the caller swaps at
every call (the trainer's EMA): the sampler rewrites its operands in place
(``load_params``), so its captured graph is replayed, not captured again.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling

MASK64 = (1 << 64) - 1
SPLITMIX_GAMMA = 0x9E3779B97F4A7C15
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
host_reads = 0  # the train windows' loss reads in this process (``_window``)


class Mesh:
    """An ordered list of devices, one per shard; entries may repeat."""

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh holds at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, by default over this process's CUDA devices
    (``process_devices``): all the visible ones, or under a process group
    this process's share of its host's. With no CUDA device it raises: it
    never falls back to the CPU unless ``devices`` names it
    (``["cpu"] * 8``). JAX's ``make_mesh(local=True)`` is the default here:
    a process's mesh never holds another process's devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; name the devices "
                               "(devices=['cpu'] * n) to run on the CPU")
        devices = process_devices(torch.cuda.device_count(), *host_share())
    return Mesh(devices)


def process_devices(n_visible: int, local_rank: int, local_count: int) -> List[torch.device]:
    """Process ``local_rank``'s share of a host's ``n_visible`` CUDA devices
    when ``local_count`` processes run there: a contiguous share, the first
    ``n_visible % local_count`` taking one more; with more processes than
    devices, the device ``local_rank % n_visible``, which it shares."""
    if local_count <= n_visible:
        per, extra = divmod(n_visible, local_count)
        start = local_rank * per + min(local_rank, extra)
        idx = range(start, start + per + (local_rank < extra))
    else:
        idx = [local_rank % n_visible]
    return [torch.device("cuda", i) for i in idx]


_HOST_SHARE: Optional[Tuple[int, int]] = None  # set by init_distributed
_GRAD_GROUP = None  # the NCCL group of the gradient all-reduce, where there is one


def host_share() -> Tuple[int, int]:
    """(this process's index among the processes of its host, their count):
    what ``init_distributed`` found by gathering the hosts' names, else
    torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE for a group set up elsewhere,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if _HOST_SHARE is not None:
            return _HOST_SHARE
        if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
            return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    return 0, 1


def mesh_route(mesh: Optional[Mesh], device) -> Tuple[Optional[Mesh], object]:
    """``(mesh, device)`` for a builder that takes both: a mesh of one device
    is the single-device route on that device, ``(None, its device)``;
    a larger mesh keeps its mesh and runs its join on its first device."""
    if mesh is None:
        return None, device
    return (mesh if mesh.size > 1 else None), mesh.devices[0]


def device_scope(device: torch.device):
    """The CUDA device context of ``device`` (streams, graph capture), or
    nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> List[torch.Tensor]:
    """``x`` split along ``axis`` into ``mesh.size`` contiguous equal shards,
    each moved to its shard's device. The counterpart of ``shard_batch``."""
    n = mesh.size
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not divide into "
                         f"{n} shards")
    return [part.to(dev).contiguous()
            for part, dev in zip(torch.chunk(x, n, dim=axis), mesh.devices)]


def join_rows(mesh: Mesh, parts: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    """The shards' results joined in shard order on the mesh's first device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts], dim=axis)


def fold_seed(draw: int, r: int) -> int:
    """Shard ``r``'s seed from the caller's 64-bit ``draw``: output ``r + 1``
    of the splitmix64 sequence started at ``draw`` (a counter hash)."""
    z = (draw + (r + 1) * SPLITMIX_GAMMA) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def draw64(generator: Optional[torch.Generator]) -> int:
    """One 64-bit draw from ``generator`` (the default CPU generator when
    None). A generator on the card costs one host synchronisation."""
    dev = generator.device if generator is not None else torch.device("cpu")
    t = torch.empty((1,), dtype=torch.int64, device=dev).random_(-2 ** 63, None,
                                                                 generator=generator)
    return int(t.item()) & MASK64


def shard_generators(mesh: Mesh, generator: Optional[torch.Generator]) -> List[torch.Generator]:
    """One generator a shard, on its device, seeded by ``fold_seed`` of one
    draw from ``generator``."""
    draw = draw64(generator)
    return [torch.Generator(device=dev).manual_seed(fold_seed(draw, r))
            for r, dev in enumerate(mesh.devices)]


def build_shards(mesh: Mesh, shape: Tuple[int, int], build: Callable, what: str) -> list:
    """``build(device, (B // n, D))`` for each shard's device. A batch that
    does not divide into the mesh's shards raises."""
    batch, dim = shape
    if batch % mesh.size:
        raise ValueError(f"{what}: batch {batch} must be divisible by the mesh size "
                         f"{mesh.size}")
    shards = []
    for dev in mesh.devices:
        with device_scope(dev):
            shards.append(build(dev, (batch // mesh.size, dim)))
    return shards


def run_shards(mesh: Mesh, shards: Sequence[Callable], generator: Optional[torch.Generator],
               inputs: Dict[str, Tuple[Optional[torch.Tensor], int]]) -> list:
    """``shards[r](generator_r, **inputs_r)`` for each shard in order, from
    this thread and with no host synchronisation between them: ``inputs``
    maps a keyword to ``(tensor, axis)``, split by ``shard_rows`` (None is
    not passed). Returns the shards' results in order."""
    gens = shard_generators(mesh, generator)
    split = {k: shard_rows(mesh, t, axis) for k, (t, axis) in inputs.items() if t is not None}
    outs = []
    for r, (dev, fn) in enumerate(zip(mesh.devices, shards)):
        with device_scope(dev):
            outs.append(fn(gens[r], **{k: v[r] for k, v in split.items()}))
    return outs


def loops_of(shards: Sequence) -> tuple:
    """The shards' ``GraphLoop``s, in shard order."""
    return tuple(lp for s in shards for lp in s.loops)


def _row_axis(t: torch.Tensor) -> int:
    """The rows of a result: axis -2 of ``[..., B, D]`` (a state, or a
    trajectory [T, B, D]), axis 0 of a vector [B]."""
    return t.ndim - 2 if t.ndim >= 2 else 0


def join_result(mesh: Mesh, outs: Sequence):
    """The shards' results joined: a tensor by its rows (``_row_axis``) on
    the mesh's first device, a tuple entry by entry, each tensor so and
    anything else (an NFE count) as shard 0 gives it."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return join_rows(mesh, outs, _row_axis(first))
    return tuple(join_rows(mesh, [o[i] for o in outs], _row_axis(v))
                 if isinstance(v, torch.Tensor) else v for i, v in enumerate(first))


def shard_builder(builder: Callable, args: dict, mesh: Mesh, inputs: Sequence[str],
                  what: str) -> Callable:
    """The sharded form of a kernel builder (the port of JAX's ``_sharded_*``
    wrappers): ``builder(**args)`` again once a shard, with ``shape=(B // n,
    D)``, ``device=`` the shard's and ``mesh=None``, so each shard owns its
    operands, buffers and loop; a batch that does not divide the mesh
    raises. ``args`` holds every argument of the builder's call (its
    ``locals()`` on entry), so each reaches every shard.

    The result is called as the builder's result is, ``run(generator,
    *tensors, **tensors)``, its tensors named by ``inputs`` in their
    positional order. Every input is ``[..., rows, D]`` (z, the observation,
    the mask, the probe; EM noise [N, K, B, D] or [N, B, D]; the solver's
    noise [T, R, D]), so each one given is split by rows along axis -2 (JAX:
    ``P(..., axis, None)``). Each shard gets its folded generator
    (``shard_generators``), the shards launch in order from this thread with
    no host synchronisation between them, and their results are joined
    (``join_result``). ``run.shards`` holds the shards' functions and
    ``run.loops`` their loops; ``run.load_params(model)`` loads ``model``'s
    weights into every shard in place, where the shards can."""
    shards = build_shards(mesh, tuple(args["shape"]), lambda dev, rows: builder(
        **dict(args, shape=rows, device=dev, mesh=None)), what)

    def run(generator: Optional[torch.Generator] = None, *tensors, **named):
        if len(tensors) > len(inputs):
            raise TypeError(f"{what} takes at most {len(inputs)} tensors after the "
                            f"generator ({', '.join(inputs)})")
        named.update(zip(inputs, tensors))
        return join_result(mesh, run_shards(mesh, shards, generator,
                                            {k: (t, -2) for k, t in named.items()}))

    run.shards, run.loops = shards, loops_of(shards)
    if all(hasattr(s, "load_params") for s in shards):
        run.load_params = lambda model: [s.load_params(model) for s in shards]
    return run


def padded_split(mesh: Mesh, n: int) -> List[List[int]]:
    """``n`` items split over the mesh's shards in contiguous runs of
    ``ceil(n / mesh.size)``, the last item repeated to fill the last shards
    (as GSPMD pads a ragged batch): each shard's item indices."""
    per = -(-n // mesh.size)
    idx = list(range(n)) + [n - 1] * (per * mesh.size - n)
    return [idx[r * per:(r + 1) * per] for r in range(mesh.size)]


def generator_on(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` in ``generator``'s state, which draws what
    ``generator`` would (the CUDA generators of two cards share one stream
    type); ``generator`` does not advance."""
    device = torch.device(device)
    if device.type != generator.device.type:
        raise ValueError(f"a {generator.device.type} generator's stream cannot move to "
                         f"{device}")
    g = torch.Generator(device=device)
    g.set_state(generator.get_state())
    return g


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with its last row repeated up to ``rows`` rows."""
    n = x.shape[0]
    return x if n == rows else torch.cat([x, x[-1:].expand(rows - n, *x.shape[1:])])


def _sample_of(out):
    """(nfe or None, x) of a sampler's result, ``x`` or ``(nfe, x)``."""
    return out if isinstance(out, tuple) else (None, out)


def data_parallel_sampler(factory: Callable, mesh: Mesh, shape: Tuple[int, int]) -> Callable:
    """A sampler without a kernel, data-parallel over the mesh.

    ``factory(device, shard_shape) -> sampler`` builds one shard's sampler,
    ``sampler(generator, observation=None, mask=None, z=None) -> x`` or
    ``(nfe, x)`` (a torch sampler is bound to its device and shape, so the
    port takes a factory where JAX takes the sampler). ``run(generator=None,
    observation=None, mask=None, z=None)`` returns what a shard returns, at
    ``shape``. A batch that does not divide the mesh runs padded (the last
    row repeated) and is trimmed, as GSPMD pads."""
    batch, dim = shape
    per = -(-batch // mesh.size)
    shards = build_shards(mesh, (per * mesh.size, dim), factory, "data_parallel_sampler")

    def run(generator: Optional[torch.Generator] = None, observation=None, mask=None, z=None):
        inputs = {k: (None if t is None else pad_rows(t, per * mesh.size), 0)
                  for k, t in (("observation", observation), ("mask", mask), ("z", z))}
        outs = [_sample_of(o) for o in run_shards(mesh, shards, generator, inputs)]
        x = join_rows(mesh, [o[1] for o in outs])[:batch]
        return x if outs[0][0] is None else (outs[0][0], x)

    return run


def multi_hypothesis_imputation_sampler(factory: Callable, mesh: Mesh,
                                        shape: Tuple[int, int], hypo_num: int) -> Callable:
    """``hypo_num`` completions of every pose by an imputation sampler
    without a kernel, data-parallel over the mesh: ``run(generator,
    observation [B, D], mask [B, D]) -> [B, H, D]``, or ``(nfe, [B, H, D])``
    where the sampler returns its NFE. The hypotheses tile into rows,
    hypothesis-major, as the port's hypothesis samplers tile them (JAX
    vmaps the sampler over H keys instead), and the ``H*B`` rows run through
    ``data_parallel_sampler``."""
    batch, dim = shape
    inner = data_parallel_sampler(factory, mesh, (hypo_num * batch, dim))

    def run(generator: Optional[torch.Generator], observation, mask):
        nfe, x = _sample_of(inner(generator, observation=observation.repeat(hypo_num, 1),
                                  mask=mask.repeat(hypo_num, 1)))
        x = x.reshape(hypo_num, batch, dim).transpose(0, 1)
        return x if nfe is None else (nfe, x)

    return run


def pad_batch_to_multiple(batch: np.ndarray, multiple: int):
    """Pad dim 0 up to a multiple (repeating the last row) -> (padded, n);
    per-sample results are trimmed back to ``n`` afterwards."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(np.asarray(batch)[-1:], multiple - rem, axis=0)
    return np.concatenate([np.asarray(batch), pad], axis=0), n


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: datetime.timedelta = datetime.timedelta(seconds=300),
                     backend: str = "gloo") -> None:
    """Join the process group of a multi-process evaluation or training.

    ``coordinator`` is ``host:port`` (rendezvous ``tcp://host:port``) or a
    URL (``tcp://...``, ``file://...``) and needs ``num_processes`` and
    ``process_id``. Without it the group comes from torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), the
    counterpart of JAX's auto-detection. A missing piece raises
    ``ValueError`` naming it; the rendezvous and later collectives give up
    after ``timeout``. The processes then gather their hosts' names, so that
    ``make_mesh`` gives each process its own share of its host's devices
    (``host_share``).

    The group itself runs on gloo. ``backend`` picks the gradient
    all-reduce's (``grad_backend``): ``"gloo"``, or ``"auto"``: a second
    group over NCCL where every process of every host has a CUDA device of
    its own and NCCL is built, else gloo (NCCL refuses two ranks on one
    device). ``timeout`` bounds every collective of both."""
    import torch.distributed as dist

    if backend not in ("gloo", "auto"):
        raise ValueError(f"backend must be 'gloo' or 'auto', got {backend!r}")
    if coordinator is not None:
        missing = [f"--{name.replace('_', '-')}" for name, v in
                   (("num_processes", num_processes), ("process_id", process_id)) if v is None]
        if missing:
            raise ValueError(f"a coordinator ({coordinator}) needs {' and '.join(missing)}")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = num_processes, process_id
    else:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError("without a coordinator the process group comes from torchrun's "
                             f"environment: {', '.join(missing)} not set (or pass "
                             "--coordinator, --num-processes and --process-id)")
        url = "env://"
        world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} out of range for {world} process(es)")
    dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank,
                            timeout=timeout)
    hosts = [None] * world
    dist.all_gather_object(hosts, (socket.gethostname(),
                                   torch.cuda.device_count() if torch.cuda.is_available() else 0))
    global _HOST_SHARE, _GRAD_GROUP
    names = [h for h, _ in hosts]
    _HOST_SHARE = (names[:rank].count(names[rank]), names.count(names[rank]))
    own_cards = all(cards >= names.count(h) for h, cards in hosts)
    _GRAD_GROUP = None
    if backend == "auto" and own_cards and dist.is_nccl_available():
        torch.cuda.set_device(process_devices(torch.cuda.device_count(), *_HOST_SHARE)[0])
        _GRAD_GROUP = dist.new_group(backend="nccl", timeout=timeout)


def grad_backend() -> Optional[str]:
    """The gradient all-reduce's backend, ``"nccl"`` or ``"gloo"``; None
    without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return "nccl" if _GRAD_GROUP is not None else "gloo"


def _rank_and_size() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    """This process's rank in the process group, 0 without one."""
    return _rank_and_size()[0]


def process_count() -> int:
    """The process group's size, 1 without one."""
    return _rank_and_size()[1]


def allgather_ragged_1d(arr: np.ndarray) -> np.ndarray:
    """Every process's 1-D host array, concatenated in rank order, on every
    process. The lengths may differ (eval shards are ragged when the batch
    count does not divide the process count): gather the lengths, pad to the
    longest, gather over gloo on CPU tensors, trim."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        return arr
    import torch.distributed as dist

    n = process_count()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64))
    counts = [int(c) for c in counts]
    padded = torch.zeros(max(max(counts), 1), dtype=torch.from_numpy(arr).dtype)
    padded[:arr.shape[0]] = torch.from_numpy(arr)
    gathered = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded)
    return np.concatenate([g[:c].numpy() for g, c in zip(gathered, counts)])


def shard_eval_batches(dataset_len: int, batch_size: int,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> range:
    """This process's contiguous range of batch indices (the last partial
    batch dropped, as the reference's loader drops it): the counterpart of
    ``DistributedEvalSampler``, with no padding, the first ``n % P``
    processes taking one batch more."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    n_batches = dataset_len // batch_size
    if dataset_len % batch_size and pi == 0:
        print(f"[shard_eval_batches] dropping the final {dataset_len % batch_size} of "
              f"{dataset_len} samples (drop_last batching, batch_size={batch_size})")
    per, extra = divmod(n_batches, pc)
    start = pi * per + min(pi, extra)
    return range(start, start + per + (1 if pi < extra else 0))


# ---------------------------------------------------------------------------
# Data-parallel training
# ---------------------------------------------------------------------------

def rank_rows(global_batch: int) -> slice:
    """This process's contiguous rows of a global batch of ``global_batch``
    rows; a batch that does not divide the process count raises."""
    rank, size = _rank_and_size()
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} must be divisible by {size} processes")
    per = global_batch // size
    return slice(rank * per, (rank + 1) * per)


def shard_global_batch(batch, axis: int = 0):
    """This process's rows of the global batch ``batch`` (a tensor or a numpy
    array, the same on every process), a view along ``axis``: the counterpart
    of JAX's ``shard_global_batch`` (axis 0) and, at axis 1, of its
    ``shard_global_multi_batch`` for a ``[K, B, ...]`` window or a ``[K, B]``
    index window."""
    index = [slice(None)] * batch.ndim
    index[axis] = rank_rows(batch.shape[axis])
    return batch[tuple(index)]


def shard_global_multi_batch(batches):
    """A ``[K, B, ...]`` window's rows of this process, along axis 1."""
    return shard_global_batch(batches, axis=1)


def allreduce_mean_(grads: Sequence[Optional[torch.Tensor]],
                    losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the processes of ``grads`` (in place; None skipped) and
    of the scalar ``losses`` (returned), in one all-reduce of one flat fp32
    buffer on the gradient group (``grad_backend``)."""
    import torch.distributed as dist

    live = [g for g in grads if g is not None]
    keys = list(losses)
    flat = torch.cat([g.reshape(-1) for g in live]
                     + [torch.stack([losses[k].float() for k in keys])])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_GRAD_GROUP)
    flat.mul_(1.0 / process_count())
    parts = torch.split(flat, [g.numel() for g in live] + [len(keys)])
    torch._foreach_copy_(live, [p.view_as(g) for p, g in zip(parts, live)])
    return dict(zip(keys, parts[-1].unbind(0)))


def data_parallel_step(step_fn: Callable) -> Callable:
    """``run(state, batch, extra=None, **noise) -> loss dict``: one step of
    the global batch whose rows ``batch`` is on this process
    (``shard_global_batch``), the counterpart of JAX's
    ``data_parallel_step``. ``step_fn`` is a train step of
    ``losses.get_step_fn`` or ``fused_train.get_cuda_step_fn``; it runs with
    its row range, so its draws are the global batch's, and with
    ``allreduce_mean_`` between its backward and its update. The returned
    losses are the global batch's, the same on every process. ``extra``
    (host floats by name) rides in the same all-reduce and comes back among
    the losses as the processes' mean (a flag every process must agree on).
    Without a process group the step is ``step_fn``'s own."""
    def run(state, batch, extra: Optional[Dict[str, float]] = None, **noise):
        n = process_count()
        if n == 1:
            losses = step_fn(state, batch, **noise)
            return losses if not extra else dict(losses, **_scalars(extra, batch.device))
        rows = batch.shape[0]

        def hook(grads, losses):
            return allreduce_mean_(grads, dict(losses, **_scalars(extra or {}, batch.device)))

        return step_fn(state, batch, rows=(process_index() * rows, n * rows), grad_hook=hook,
                       **noise)

    return run


def _scalars(values: Dict[str, float], device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(float(v), device=device) for k, v in values.items()}


def _window(step: Callable, state, batches: Sequence, noise: Callable[[int], dict],
            extra: Optional[Callable[[], Dict[str, float]]]) -> list:
    """``step`` on each batch with ``noise(j)``'s draws (and ``extra()`` in
    the last step's all-reduce), then one host read of every step's losses:
    a list of ``{name: float}``. The span ``train.window``, its read
    ``train.loss_read``; ``host_reads`` counts the reads."""
    global host_reads
    last = len(batches) - 1
    with profiling.span("train.window"):
        pending = [step(state, b, extra=extra() if extra is not None and j == last else None,
                        **noise(j)) for j, b in enumerate(batches)]
        with profiling.span("train.loss_read"):
            flat = torch.cat([torch.stack(list(ld.values())) for ld in pending]).tolist()
        host_reads += 1
    out, i = [], 0
    for ld in pending:
        out.append(dict(zip(ld, flat[i:i + len(ld)])))
        i += len(ld)
    return out


def data_parallel_multi_step(step_fn: Callable) -> Callable:
    """``run(state, batches, noise, extra=None) -> [loss dict of floats] *
    K``: K data-parallel steps over a window of this process's rows,
    ``batches`` ``[K, B / n, ...]`` (``shard_global_multi_batch``) or a list
    of K such batches, then one host read of the losses (the port's
    ``--steps-per-dispatch``). ``noise(j)`` gives step j's draws (a
    generator seeded for the step, a dropout seed); it is called just
    before the step. ``extra()``, called before the last step, gives host
    floats that ride in its all-reduce and come back in its loss dict as the
    processes' mean."""
    step = data_parallel_step(step_fn)

    def run(state, batches, noise: Callable[[int], dict],
            extra: Optional[Callable[[], Dict[str, float]]] = None) -> list:
        return _window(step, state, list(batches), noise, extra)

    return run


def data_parallel_multi_step_indexed(step_fn: Callable) -> Callable:
    """``run(state, idx, data, noise, extra=None)``:
    ``data_parallel_multi_step`` on device-resident data: ``idx`` ``[K, B /
    n]`` is this process's columns of a ``[K, B]`` index window
    (``shard_global_multi_batch``), a tensor on ``data``'s device, and step
    j trains on ``data[idx[j]]``."""
    step = data_parallel_step(step_fn)

    def run(state, idx: torch.Tensor, data: torch.Tensor, noise: Callable[[int], dict],
            extra: Optional[Callable[[], Dict[str, float]]] = None) -> list:
        return _window(step, state, [data.index_select(0, i) for i in idx], noise, extra)

    return run


def data_parallel_sampler_params(sampler: Callable) -> Callable:
    """``run(params, generator=None, observation=None, mask=None, z=None)``:
    ``sampler`` (a kernel sampler of ``fused_em.get_cuda_em_sampler``, with
    ``mesh=`` or without) built once, on the weights of the model ``params``
    at each call, which it loads in place (``sampler.load_params``): a
    replayed graph stays valid, so a call after the first replays it. It
    returns what ``sampler`` returns (``(trajs, x)`` for a sampler built
    with ``trajectory_steps``). The counterpart of JAX's form, which threads
    the weights through one compiled program."""
    def run(params, *args, **kwargs):
        sampler.load_params(params)
        return sampler(*args, **kwargs)

    return run


def multi_hypothesis_imputation_sampler_params(sampler: Callable) -> Callable:
    """``run(params, generator, observation [B, D], mask [B, D]) -> [B, H,
    D]``: a hypothesis sampler of ``fused_em.get_cuda_em_hypo_sampler`` run
    as ``data_parallel_sampler_params`` runs a sampler."""
    return data_parallel_sampler_params(sampler)
