"""Tensor parallelism over the mesh's "model" axis: the port of the
``model_parallel`` half of ``multiverse_tpu/parallel/mesh.py``
(``_leaf_pspec``, ``param_pspecs``, ``init_sharded_train_state``'s
placement and the GSPMD train step when "model" > 1).

The JAX package places each leaf by :func:`leaf_pspec` and leaves the
partitioning to GSPMD. Here it is written out, Megatron-style: a sharded
parameter carries a :class:`Shard` (``param.shard``), and the layers
that meet one (``ops.layers.conv2d``, ``ops.convlstm.convlstm_step``,
``ops.layers.l2_weight_decay``) compute their block with explicit
collectives over the rank's model group:

* a conv kernel sharded on its output (last) axis is column-parallel:
  the whole input in (:meth:`Shard.copy`: the identity, whose backward
  sums the model ranks' partial input gradients), the rank's output
  channels out, gathered (:meth:`Shard.gather`: an all-gather, whose
  backward keeps the rank's own block). The scene CNN and the
  grid-embedding convs; ``h2g_reg`` / ``h2g_single`` at mp = 2;
* a kernel sharded on its input axis (``h2g_class``'s [3, 3, D, 1]) is
  row-parallel: the rank's input channels in (:meth:`Shard.scatter`,
  whose backward gathers), a partial sum out, summed over the model
  ranks (:meth:`Shard.reduce`, whose backward is the identity). The
  partial sums are f32 products of the compute-dtype operands, rounded
  to that dtype after the sum, as the single conv rounds its own;
* the ConvLSTM kernel [k, k, Cin + D, 4D] is column-parallel with a
  per-gate layout: rank m holds hidden channels [m D/mp, (m+1) D/mp) of
  each of the gates i, g, f, o (the same shard shape as JAX's
  contiguous split of the 4D axis, another order inside it). The rank
  updates its block of c, which stays its own, and gathers only h:
  B·H·W·D a step where the contiguous split would gather all four
  gates. :func:`shard_params` / :func:`gather_params` map between the
  whole tree (JAX's layout, what checkpoints hold) and the blocks.

Every activation between layers is whole on every model rank (the GNN
attention, K4/K5 on the card, runs on the gathered h on each), so the
loss is the same on each and every gradient leaves the model group
whole or as the rank's block. Gathers are all-reduces of a zero-filled
buffer (x + 0 is exact): gloo takes CUDA tensors for all-reduce and
broadcast only, and two ranks sharing a card must use gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

from multiverse_torch.bridge import _tensor_tree
from multiverse_torch.models import Multiverse
from multiverse_torch.ops.layers import conv_nhwc

MODEL = "model"


def leaf_pspec(shape, mp: int) -> Tuple:
    """JAX's ``_leaf_pspec`` as the tuple of its PartitionSpec's entries:
    the last axis over "model" when ``mp`` divides it, else the
    second-to-last, else replicated (``()``); no trailing None."""
    shape = tuple(shape)
    if mp == 1:
        return ()
    if len(shape) >= 1 and shape[-1] % mp == 0:
        return (None,) * (len(shape) - 1) + (MODEL,)
    if len(shape) >= 2 and shape[-2] % mp == 0:
        return (None,) * (len(shape) - 2) + (MODEL,)
    return ()


def sharded_axis(shape, mp: int) -> Optional[int]:
    """The axis :func:`leaf_pspec` shards, or None."""
    spec = leaf_pspec(shape, mp)
    return len(spec) - 1 if spec else None


def param_pspecs(params, mesh) -> dict:
    """JAX's ``param_pspecs``: the tree of :func:`leaf_pspec` tuples at
    the mesh's model size, over a nested mapping of tensors or arrays or
    a :class:`~multiverse_torch.models.Multiverse`."""
    if isinstance(params, torch.nn.Module):
        params = _tensor_tree(params)
    mp = mesh.model_parallel
    return {k: param_pspecs(v, mesh) if isinstance(v, Mapping)
            else leaf_pspec(v.shape, mp) for k, v in params.items()}


# ------------------------------------------------------------ collectives


def _gather_last(mesh, t: torch.Tensor) -> torch.Tensor:
    """The model ranks' ``t`` concatenated along the last axis in model
    order: an all-reduce of a zero-filled buffer."""
    mp, m = mesh.model_parallel, mesh.model_index
    n = t.shape[-1]
    out = torch.zeros(t.shape[:-1] + (n * mp,), dtype=t.dtype,
                      device=t.device)
    out[..., m * n:(m + 1) * n] = t
    return mesh.model_all_reduce(out)


def _own_block(mesh, t: torch.Tensor) -> torch.Tensor:
    n = t.shape[-1] // mesh.model_parallel
    return t[..., mesh.model_index * n:(mesh.model_index + 1) * n] \
        .contiguous()


class _Copy(torch.autograd.Function):
    """Identity forward; the model ranks' gradients summed backward."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.model_all_reduce(
            g.clone(memory_format=torch.contiguous_format))


class _Reduce(torch.autograd.Function):
    """Sum over the model ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, mesh, x):
        return mesh.model_all_reduce(
            x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Gather(torch.autograd.Function):
    """The ranks' channel blocks concatenated forward; the rank's own
    block of the gradient backward."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _gather_last(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return None, _own_block(ctx.mesh, g)


class _Scatter(torch.autograd.Function):
    """The rank's own channel block forward; the blocks' gradients
    gathered backward."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _own_block(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return None, _gather_last(ctx.mesh, g.contiguous())


# ----------------------------------------------------------------- shards


@dataclasses.dataclass(eq=False)
class Shard:
    """How a parameter is a block of its whole leaf: ``axis`` of
    ``shape`` (the whole shape) split over the ``mesh``'s model ranks,
    contiguously or, for a ConvLSTM's kernel and bias (``gates``), D/mp
    channels of each of its four gates. The layer functions call the
    collectives through it."""

    mesh: object
    axis: int
    shape: Tuple[int, ...]
    gates: bool = False

    # the four boundaries (autograd Functions over the model group)
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(self.mesh, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(self.mesh, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(self.mesh, x)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _Scatter.apply(self.mesh, x)

    def conv2d(self, params, x, stride, activation, compute_dtype):
        """``ops.layers.conv2d`` of a kernel block: column-parallel when
        the output axis is split, row-parallel when the input axis is."""
        dtype = compute_dtype or torch.float32
        w = params["w"]
        if self.axis == len(self.shape) - 1:
            out = conv_nhwc(w, self.copy(x), stride, dtype)
            if "b" in params:
                out = out + params["b"].to(dtype)
            if activation is not None:
                out = activation(out)
            return self.gather(out).float()
        # row-parallel: f32 partial sums of the compute-dtype operands
        part = conv_nhwc(w.to(dtype).float(),
                         self.scatter(x.to(dtype)).float(), stride,
                         torch.float32)
        out = self.reduce(part).to(dtype)
        if "b" in params:
            out = out + params["b"].to(dtype)
        if activation is not None:
            out = activation(out)
        return out.float()

    # whole <-> block
    def _view(self, whole: torch.Tensor) -> torch.Tensor:
        """``whole`` with the split axis unflattened to [..., mp, n]
        ([..., 4, mp, D/mp] for gates), model index at -2."""
        mp = self.mesh.model_parallel
        moved = whole.movedim(self.axis, -1)
        if self.gates:
            return moved.unflatten(-1, (4, mp, -1))
        return moved.unflatten(-1, (mp, -1))

    def block(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf."""
        own = self._view(whole)[..., self.mesh.model_index, :]
        if self.gates:
            own = own.flatten(-2)
        return own.movedim(-1, self.axis).contiguous()

    def place(self, whole: torch.Tensor, block: torch.Tensor) -> None:
        """Write ``block`` into its place in ``whole``, in place."""
        dst = self._view(whole)[..., self.mesh.model_index, :]
        src = block.movedim(self.axis, -1)
        if self.gates:
            src = src.unflatten(-1, (4, -1))
        dst.copy_(src)


def _is_lstm(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("kernel", "bias")


def leaf_shard(mesh, name: str, shape) -> Optional[Shard]:
    """The :class:`Shard` of leaf ``name`` of whole ``shape`` on
    ``mesh``, or None for a replicated leaf. A ConvLSTM leaf split on its
    gate axis needs mp to divide its hidden size."""
    shape = tuple(shape)
    axis = sharded_axis(shape, mesh.model_parallel)
    if axis is None:
        return None
    gates = _is_lstm(name) and axis == len(shape) - 1
    if gates and (shape[-1] // 4) % mesh.model_parallel:
        raise ValueError(
            f"{name}: hidden size {shape[-1] // 4} is not divisible by "
            f"model_parallel={mesh.model_parallel} (a ConvLSTM is split "
            f"by hidden channel)")
    return Shard(mesh, axis, shape, gates)


def is_sharded(model) -> bool:
    return any(getattr(p, "shard", None) is not None
               for p in model.parameters())


def _module(named, trainable: bool = False) -> Multiverse:
    """A :class:`Multiverse` of (dotted name, tensor) pairs."""
    tree: dict = {}
    for name, t in named:
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return Multiverse(tree, trainable)


def shard_params(mesh, whole):
    """This rank's blocks of a whole :class:`Multiverse` (every rank
    holds the same), as a trainable module on the rank's device whose
    sharded parameters carry their :class:`Shard`. The whole tree stays
    as it was."""
    shards = {n: leaf_shard(mesh, n, p.shape)
              for n, p in whole.named_parameters()}
    model = _module(((n, (p if shards[n] is None else shards[n].block(p))
                      .detach().to(mesh.device, copy=True))
                     for n, p in whole.named_parameters()), trainable=True)
    for n, p in model.named_parameters():
        if shards[n] is not None:
            p.shard = shards[n]
    return model


@torch.no_grad()
def gather_params(mesh, model):
    """The whole parameters of a tensor-parallel ``model`` on every model
    rank, as a frozen :class:`Multiverse` in JAX's layout (equal to the
    tree :func:`shard_params` split, at tolerance 0): one all-reduce of
    every sharded leaf's zero-filled whole, each rank's block in place.
    A model with no sharded parameter is returned as it is."""
    if not is_sharded(model):
        return model
    wholes = {}
    for n, p in model.named_parameters():
        if getattr(p, "shard", None) is not None:
            wholes[n] = torch.zeros(p.shard.shape, dtype=p.dtype,
                                    device=p.device)
            p.shard.place(wholes[n], p)
    flat = mesh.model_all_reduce(
        torch.cat([w.reshape(-1) for w in wholes.values()]))
    at = 0
    for n, w in wholes.items():
        wholes[n] = flat[at:at + w.numel()].view_as(w)
        at += w.numel()
    return _module((n, wholes[n] if n in wholes else p.detach().clone())
                   for n, p in model.named_parameters())
