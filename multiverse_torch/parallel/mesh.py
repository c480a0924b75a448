"""Data and tensor parallelism over GPUs: the port of
``multiverse_tpu/parallel/mesh.py``.

The JAX package drives every chip from one process (``shard_map`` and
``psum``). The port's steps are host-bound (thousands of eager launches
a train step), so one Python thread enqueueing for N GPUs would divide
each GPU's share of the host by N. Here each device gets its own process
and the collectives are explicit ``torch.distributed`` calls: ``nccl``
between GPUs, ``gloo`` on the CPU (and for two ranks sharing one GPU,
which NCCL refuses).

* :func:`make_mesh` / :func:`make_mesh_for_batch` plan the ranks (one
  device each) on a ``("data", "model")`` grid, rank r = d * mp + m as
  JAX's reshape orders it, and :func:`launch` starts them: in this
  process and with no group at world 1, else one spawned process per
  rank, each joined to the world group, to its data group (the ranks of
  its model index) and to its model group (the ranks of its data
  index), with a rank's failure failing the launch;
* :func:`shard_batch` gives data index d the d-th contiguous block of
  the leading axis (``P("data")``'s order); the scene table stays whole
  on every rank, because ``obs_scene`` indexes it globally;
* :func:`make_sharded_train_step`: local gradients, one all-reduce of
  all of them in one bucket over the data group divided by its size
  (pmean), one of the loss parts, then the same optimizer update on
  every data rank; :func:`compute_loss` sums the masked regression's
  normaliser over the data group;
* with ``model_parallel`` > 1 (``parallel/tensor.py``) each rank holds
  its block of every sharded leaf and the optimizer slots made from it
  (:func:`init_sharded_train_state`), and the forward and backward
  compute channel blocks with collectives over the model group;
* :func:`make_sharded_eval_step` / :func:`make_sharded_beam_step`: the
  whole weights (gathered once a call under tensor parallelism, JAX's
  ``P()`` params), the local forward or beam decode on the data index's
  slice, the outputs gathered in data order on every rank.

Every rank runs the full kernel path on its slice (K4/K5 in training,
on the gathered hidden state on every model rank; K1/K2/K3/K7 in
decoding).
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import multiprocessing
import os
import queue
import signal
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data.dataset import batch_to_device
from multiverse_torch.inference import beam_forward
from multiverse_torch.models import Batch, compute_loss, model_forward
from multiverse_torch.parallel.tensor import gather_params, shard_params
from multiverse_torch.train.trainer import gradients, make_eval_step

# the rendezvous of :func:`launch` gives up after this; a collective
# that waits longer than COLLECTIVE_TIMEOUT_S fails its group
RENDEZVOUS_TIMEOUT_S = 120.0
COLLECTIVE_TIMEOUT_S = 1800.0


# ------------------------------------------------------------------ mesh


@dataclasses.dataclass
class Mesh:
    """The ranks on a ``("data", "model")`` grid: one device a rank
    (``devices[r]``), rank r at data index r // mp and model index
    r % mp. In a rank's own process: its ``rank``, the world ``group``,
    its ``data_group`` (the ranks of its model index, None at dp 1) and
    its ``model_group`` (the ranks of its data index, None at mp 1). A
    plan (from :func:`make_mesh`) has no group until :func:`launch`
    joins it; at world 1 it keeps none and every collective is a no-op.
    ``collectives`` counts the collective calls this rank made through
    :meth:`all_reduce_sum`, :meth:`model_all_reduce` and
    :meth:`broadcast`; ``model_collectives`` and ``model_bytes`` the
    model group's calls and the bytes of their buffers. A collective
    that waits longer than ``timeout_s`` fails its group."""

    devices: Tuple[torch.device, ...]
    backend: str
    model_parallel: int = 1
    rank: int = 0
    group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    collectives: int = 0
    model_collectives: int = 0
    model_bytes: int = 0
    timeout_s: float = COLLECTIVE_TIMEOUT_S

    @property
    def world(self) -> int:
        return len(self.devices)

    @property
    def dp(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.model_parallel}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group in place (a no-op without one)."""
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
            self.collectives += 1
        return t

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group in place (a no-op without
        one)."""
        if self.model_group is not None:
            dist.all_reduce(t, group=self.model_group)
            self.collectives += 1
            self.model_collectives += 1
            self.model_bytes += t.numel() * t.element_size()
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        if self.group is not None:
            dist.broadcast(t, src=0, group=self.group)
            self.collectives += 1
        return t


def visible_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every visible device of a type: the CUDA devices that
    ``CUDA_VISIBLE_DEVICES`` leaves, or the one host for ``cpu``."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> Mesh:
    """A ``(len // model_parallel, model_parallel)`` mesh over
    ``devices`` (default: the first ``n_devices`` of the visible ones of
    ``device_type``; all of them when None). The backend is ``nccl`` for
    distinct GPUs and ``gloo`` otherwise; NCCL refuses two ranks on one
    device."""
    if devices is None:
        devices = visible_devices(device_type)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"expected {n_devices} devices, found {len(devices)} "
                    f"(type={device_type})")
            devices = devices[:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if n == 0:
        raise ValueError(f"no {device_type} device is visible")
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    distinct_gpus = (all(d.type == "cuda" for d in devices)
                     and len(set(devices)) == n)
    return Mesh(devices=devices, model_parallel=model_parallel,
                backend="nccl" if distinct_gpus else "gloo")


def make_mesh_for_batch(batch_size: int, model_parallel: int = 1,
                        devices: Optional[Sequence] = None) -> Mesh:
    """A mesh whose data axis is the largest divisor of ``batch_size``
    that fits the visible GPUs (or ``devices``) divided by
    ``model_parallel``: small batches use fewer devices instead of
    failing on divisibility. Fewer devices than ``model_parallel`` is a
    ``ValueError``, as in the JAX package."""
    if devices is None:
        devices = visible_devices()
    avail = len(devices) // model_parallel
    if avail == 0:
        raise ValueError(
            f"model_parallel={model_parallel} needs {model_parallel} "
            f"devices, found {len(devices)}")
    dp = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    return make_mesh(devices=list(devices)[:dp * model_parallel],
                     model_parallel=model_parallel)


# ------------------------------------------------------------ placement


def shard_batch(mesh: Mesh, batch) -> Batch:
    """This rank's block of a host (numpy) Batch on its device: the d-th
    contiguous block of every leading axis at data index d (the model
    ranks of one data index hold the same), the scene table whole."""
    n = len(batch.obs_grid_class)
    if n % mesh.dp != 0:
        raise ValueError(f"batch of {n} not divisible by the mesh data "
                         f"axis ({mesh.dp})")
    b = n // mesh.dp
    lo, hi = mesh.data_index * b, (mesh.data_index + 1) * b

    def block(name, a):
        if a is None or name == "scene_feat":
            return a
        if isinstance(a, tuple):
            return tuple(x[lo:hi] for x in a)
        return a[lo:hi]

    local = type(batch)(*(block(name, a) for name, a in
                          zip(batch._fields, batch)))
    return batch_to_device(local, mesh.device)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]):
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """pmean over the data group, in place, of tensors of one dtype: one
    all-reduce of one flattened bucket, divided by the group's size."""
    if mesh.data_group is None or not tensors:
        return
    flat = mesh.all_reduce_sum(_flat(tensors))
    _unflat_into(flat / mesh.dp, tensors)


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every data index's ``t`` stacked along the leading axis in data
    order, on every rank. An all-reduce over the data group of a
    zero-filled buffer that each rank writes its block into: gloo takes
    CUDA tensors for all-reduce and broadcast only, so the same code
    runs under both backends (x + 0 is exact)."""
    if mesh.data_group is None:
        return t
    n = t.shape[0]
    out = torch.zeros((n * mesh.dp,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    out[mesh.data_index * n:(mesh.data_index + 1) * n] = t
    return mesh.all_reduce_sum(out)


def broadcast_params(mesh: Mesh, model) -> None:
    """Rank 0's weights into every rank's ``model`` (the same names and
    shapes on every rank, on its device), in place: one broadcast of all
    parameters in one bucket, in name order."""
    params = [p.data for _, p in sorted(model.named_parameters())]
    if mesh.group is not None and params:
        _unflat_into(mesh.broadcast(_flat(params)), params)


def replicate(mesh: Mesh, model):
    """``model`` on this rank's device with rank 0's weights."""
    model = model.to(mesh.device)
    broadcast_params(mesh, model)
    return model


# ----------------------------------------------------------------- steps


def rank_seed(mesh: Mesh, rng: Optional[int]) -> Optional[int]:
    """A dropout seed per data index, distinct from every other data
    index's (the ``fold_in(rng, axis_index("data"))`` of the JAX step)
    and the same on the model ranks of one, whose replicated activations
    must draw the same masks; the step's own seed at dp 1."""
    return None if rng is None else rng * mesh.dp + mesh.data_index


def sharded_loss_and_grads(model, batch: Batch, cfg: MultiverseConfig,
                           mesh: Mesh, rng: Optional[int] = None):
    """The local shard's forward, loss and gradients, then the
    gradients (one bucket) and the loss parts averaged over the data
    group. Returns ({name: gradient of this rank's block}, {loss name:
    scalar, "total" included}), the losses the same on every rank."""
    out = model_forward(model, batch, cfg, is_train=True,
                        rng=rank_seed(mesh, rng))
    total, parts = compute_loss(model, batch, out, cfg, mesh=mesh)
    grads = gradients(model, total)
    all_reduce_mean(mesh, list(grads.values()))
    parts = dict(parts, total=total)
    losses = torch.stack([v.detach().float().reshape(())
                          for v in parts.values()])
    all_reduce_mean(mesh, [losses])
    return grads, dict(zip(parts, losses.unbind(0)))


def make_sharded_train_step(cfg: MultiverseConfig, tx, mesh: Mesh):
    """``step(model, opt_state, batch, rng=None) -> losses``: the
    data- and tensor-parallel counterpart of ``trainer.make_train_step``
    on this rank's shard (:func:`shard_batch`) and, under tensor
    parallelism, its parameter blocks (:func:`init_sharded_train_state`).
    The averaged gradients feed the same elementwise in-place update on
    every data rank; the returned losses are the data ranks' averages,
    on the device."""

    def step(model, opt_state: dict, batch: Batch,
             rng: Optional[int] = None):
        grads, parts = sharded_loss_and_grads(model, batch, cfg, mesh, rng)
        tx.update(dict(model.named_parameters()), grads, opt_state)
        return parts

    return step


def init_sharded_train_state(model, tx, mesh: Mesh):
    """Rank 0's weights on every rank (:func:`replicate`), trainable,
    and the optimizer slots made on each. Under tensor parallelism each
    rank keeps only its block of every sharded leaf
    (``tensor.shard_params``) and makes the slots from those blocks, as
    the JAX package places its accumulators like the parameters. Returns
    (model, opt_state)."""
    model = replicate(mesh, model)
    if mesh.model_parallel > 1:
        model = shard_params(mesh, model)
    model.requires_grad_(True)
    return model, tx.init(dict(model.named_parameters()))


def map_tensors(fn: Callable, tree):
    """``fn`` over every tensor of a nested tuple / NamedTuple / list /
    dict, None kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_tensors(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def gather_outputs(mesh: Mesh, tree):
    """:func:`gather_rows` over every tensor of a tree (the batch axis
    leading)."""
    return map_tensors(lambda t: gather_rows(mesh, t), tree)



def make_sharded_eval_step(cfg: MultiverseConfig, mesh: Mesh):
    """``step(model, shard) -> (class logits, reg)`` per scale: the
    eval-mode forward on the rank's shard, gathered in data order on
    every rank. A tensor-parallel model is gathered whole first
    (``tensor.gather_params``; a caller that evaluates many batches
    gathers once and passes the whole model)."""
    local = make_eval_step(cfg)

    def step(model, batch: Batch):
        cl, rg = local(gather_params(mesh, model), batch)
        with torch.inference_mode():
            return gather_outputs(mesh, cl), gather_outputs(mesh, rg)

    return step


def make_sharded_beam_step(cfg: MultiverseConfig, mesh: Mesh,
                           T_pred: Optional[int] = None):
    """``step(model, shard) -> (BeamOutputs, reg_out)``: the diverse
    beam decode of the rank's trajectories (K beams stay with their
    trajectory's rank), gathered in data order on every rank; a
    tensor-parallel model is gathered whole first."""
    def step(model, batch: Batch):
        model = gather_params(mesh, model)
        with torch.inference_mode():
            beam, reg = beam_forward(model, batch, cfg, T_pred=T_pred)
            return gather_outputs(mesh, beam), gather_rows(mesh, reg)

    return step


# ---------------------------------------------------------------- launch


def _subgroups(mesh: Mesh, rank: int):
    """(data group, model group) of ``rank``: the world where it is the
    whole axis, None where the axis has size 1. Every rank makes every
    subgroup, in one order (``new_group`` is collective over the
    world)."""
    mp, dp = mesh.model_parallel, mesh.dp
    if mp == 1:
        return dist.group.WORLD, None
    if dp == 1:
        return None, dist.group.WORLD
    data = [dist.new_group([d * mp + m for d in range(dp)])
            for m in range(mp)]
    model = [dist.new_group([d * mp + m for m in range(mp)])
             for d in range(dp)]
    return data[rank % mp], model[rank // mp]


def _join(mesh: Mesh, rank: int, store) -> Mesh:
    """This rank's view of ``mesh``, joined to a new default group and
    its data and model subgroups."""
    device = mesh.devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        mesh.backend, store=store, rank=rank, world_size=mesh.world,
        timeout=datetime.timedelta(seconds=mesh.timeout_s))
    data, model = _subgroups(mesh, rank)
    return dataclasses.replace(mesh, rank=rank, group=dist.group.WORLD,
                               data_group=data, model_group=model,
                               collectives=0)


def _die_with_parent() -> None:
    """Linux: the kernel kills this process when its parent dies, so a
    rank never outlives a launcher that was killed outright."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGKILL)    # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank_main(fn, mesh: Mesh, rank: int, port: int, args, results):
    """A spawned rank: one thread for torch's CPU ops, join the group,
    run ``fn``, report (rank, ok, value or traceback)."""
    _die_with_parent()
    torch.set_num_threads(1)
    # every rank of a launch is on this host: talk over loopback, not
    # over the interface gloo and NCCL would look up from the hostname
    # (gloo's look-up alone cost seconds a rank on a GPU host)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        store = dist.TCPStore(
            "127.0.0.1", port, mesh.world, is_master=False,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        ranked = _join(mesh, rank, store)
        try:
            value = fn(ranked, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        # reported first: the launcher names this rank and its error
        results.put((rank, False, traceback.format_exc()))
        raise


def _exit_on_sigterm(*_) -> None:
    raise SystemExit(143)


def _prebuild(mesh: Mesh) -> None:
    """Build the kernel library once before the ranks start, so they
    load it instead of each running nvcc."""
    if any(d.type == "cuda" for d in mesh.devices):
        from multiverse_torch.ops import _build
        _build.build()


def launch(fn: Callable, mesh: Mesh, *args,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(rank_mesh, *args)`` on every rank of ``mesh`` and return
    the ranks' return values in rank order.

    At world 1, ``fn`` runs in this process with no group: one device
    needs no collective, and a group of one would still flatten and
    all-reduce the gradients every step. Otherwise each rank is a
    ``spawn``ed process (``fn`` and ``args`` must pickle) that joins a
    group through a store this process serves on a free localhost port.
    A rank's exception, a rank that dies, a failed
    rendezvous or ``timeout`` seconds passing fails the launch with a
    ``RuntimeError`` (``TimeoutError``) naming the rank; every rank still
    running is then terminated, so none outlives the call."""
    if mesh.world == 1:
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        return [fn(dataclasses.replace(mesh, rank=0, collectives=0), *args)]
    store = dist.TCPStore(
        "127.0.0.1", 0, mesh.world, is_master=True, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    _prebuild(mesh)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"mvt-rank-{r}",
                         args=(fn, mesh, r, store.port, args, results),
                         daemon=True)
             for r in range(mesh.world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    values: dict = {}
    # a SIGTERM to this process unwinds through the finally below, which
    # stops the ranks (the default action would orphan them)
    main_thread = threading.current_thread() is threading.main_thread()
    old_term = signal.getsignal(signal.SIGTERM) if main_thread else None
    if main_thread and old_term in (signal.SIG_DFL, None):
        signal.signal(signal.SIGTERM, _exit_on_sigterm)
    try:
        for p in procs:
            p.start()
        while len(values) < mesh.world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode is not None]
                if dead:
                    # a rank that exits flushes its report first: one
                    # more look before calling it dead
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            "rank %d exited with code %s and no result"
                            % (dead[0], procs[dead[0]].exitcode)) from None
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "ranks %s did not finish within %.0f s" % (
                            [r for r in range(mesh.world)
                             if r not in values], timeout))
                else:
                    continue
            if not ok:
                raise RuntimeError("rank %d failed:\n%s" % (rank, value))
            values[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        if main_thread and old_term in (signal.SIG_DFL, None):
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [values[r] for r in range(mesh.world)]
