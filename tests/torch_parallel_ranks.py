"""The rank functions of ``tests/test_torch_parallel.py``.

``multiverse_torch.parallel.launch`` starts each rank in a fresh
``spawn`` process that imports the function's module: this one imports
torch and the port only, never jax or the JAX package (the test module
does, to compute the references, and hands the ranks numpy arrays).
"""

import builtins
import os
from unittest import mock

import torch

from multiverse_torch import parallel
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.models import compute_loss, model_forward
from multiverse_torch.parallel.mesh import rank_seed
from multiverse_torch.serving.engine import ServingEngine
from multiverse_torch.train import trainer


def train_steps(mesh, cfg, tree, batches, num_examples, rngs=None):
    """The data- (and tensor-) parallel step over ``batches`` (host
    Batches) from the weights ``tree``. Returns (per-step losses, final
    whole weights as a numpy tree, this rank's collective calls)."""
    tx = trainer.build_optimizer(cfg, num_examples)
    model, opt_state = parallel.init_sharded_train_state(
        params_from_jax(tree), tx, mesh)
    step = parallel.make_sharded_train_step(cfg, tx, mesh)
    losses = []
    for i, batch in enumerate(batches):
        parts = step(model, opt_state, parallel.shard_batch(mesh, batch),
                     None if rngs is None else rngs[i])
        losses.append({k: float(v) for k, v in parts.items()})
    calls = mesh.collectives
    whole = params_to_numpy_tree(parallel.gather_params(mesh, model))
    return losses, whole, calls


def dropout_losses(mesh, cfg, tree, batch, rng):
    """This rank's local train-mode loss with dropout (its own seed) and
    with none, then one data-parallel dropout step's averaged total."""
    model = parallel.replicate(mesh, params_from_jax(tree))
    shard = parallel.shard_batch(mesh, batch)
    with torch.no_grad():
        out = model_forward(model, shard, cfg, is_train=True,
                            rng=rank_seed(mesh, rng))
        dropped = float(compute_loss(model, shard, out, cfg)[0])
        plain_cfg = cfg.replace(keep_prob=1.0)
        out = model_forward(model, shard, plain_cfg, is_train=True)
        plain = float(compute_loss(model, shard, out, plain_cfg)[0])
    tx = trainer.build_optimizer(cfg, 40)
    model, opt_state = parallel.init_sharded_train_state(model, tx, mesh)
    parts = parallel.make_sharded_train_step(cfg, tx, mesh)(
        model, opt_state, shard, rng)
    return dropped, plain, float(parts["total"])


def infer(mesh, cfg, tree, batch):
    """The sharded eval step's and beam step's gathered outputs."""
    model = parallel.replicate(mesh, params_from_jax(tree))
    shard = parallel.shard_batch(mesh, batch)
    cl, rg = parallel.make_sharded_eval_step(cfg, mesh)(model, shard)
    beam, reg = parallel.make_sharded_beam_step(cfg, mesh)(model, shard)
    return parallel.map_tensors(lambda t: t.numpy(), (cl, rg, beam, reg))


def serve(mesh, cfg, tree, new_tree, requests, max_batch):
    """A mesh ServingEngine: rank 0 answers ``requests`` ((obs, scene
    map or None, pred_len) each, submitted together), swaps in
    ``new_tree`` with ``update_params`` and answers them again; the other
    ranks serve their blocks. Returns rank 0's (answers before, after,
    [stats before, stats after]) as numpy."""
    engine = ServingEngine(params_from_jax(tree), cfg, max_batch=max_batch,
                           max_delay_ms=20.0, T_pred=cfg.pred_len,
                           device="cpu", mesh=mesh)
    if not mesh.is_main:
        engine.run_worker()
        return None
    try:
        engine.warmup()

        def answers():
            handles = [engine.submit(obs, scene, pl)
                       for obs, scene, pl in requests]
            out = []
            for h in handles:
                if not h.event.wait(60):
                    raise TimeoutError("no answer within 60 s")
                if h.error is not None:
                    raise h.error
                out.append((h.result.trajs, h.result.logprobs))
            return out

        before = answers()
        stats = [engine.stats.snapshot()]
        engine.stats.reset()
        engine.update_params(params_from_jax(new_tree))
        after = answers()
        return before, after, stats + [engine.stats.snapshot()]
    finally:
        engine.close()


def train_cli(mesh, argv, guard_root):
    """``mvt-torch-train``'s rank worker. On ranks other than 0 every
    write under ``guard_root`` (a file opened for writing, a directory
    made, a rename) raises, so the run fails if any rank but 0 writes
    the run directory."""
    from multiverse_torch.cli import train as ttrain

    args = ttrain.build_parser().parse_args(argv)
    if mesh.is_main:
        return ttrain.train_worker(mesh, args)
    root = os.path.realpath(guard_root)

    def inside(path) -> bool:
        return isinstance(path, (str, bytes, os.PathLike)) and \
            os.path.realpath(os.fsdecode(path)).startswith(root)

    def refuse(what, path):
        raise AssertionError(f"rank {mesh.rank} {what} {path}")

    real_open, real_makedirs, real_replace = (builtins.open, os.makedirs,
                                              os.replace)

    def guarded_open(file, mode="r", *a, **kw):
        if inside(file) and any(c in mode for c in "wax+"):
            refuse("opened for writing", file)
        return real_open(file, mode, *a, **kw)

    def guarded_makedirs(name, *a, **kw):
        if inside(name):
            refuse("made", name)
        return real_makedirs(name, *a, **kw)

    def guarded_replace(src, dst, *a, **kw):
        if inside(dst):
            refuse("renamed into", dst)
        return real_replace(src, dst, *a, **kw)

    with mock.patch.object(builtins, "open", guarded_open), \
            mock.patch.object(os, "makedirs", guarded_makedirs), \
            mock.patch.object(os, "replace", guarded_replace):
        return ttrain.train_worker(mesh, args)


# ------------------------------------------------- tensor parallelism


def boundary(mesh, kind, arrays):
    """One layer with its weights split over the model ranks
    (``tensor.Shard``): ``column`` / ``row`` a conv2d (ReLU) sharded on
    its output / input channels, ``lstm`` a ConvLSTM step by hidden
    channel. ``arrays``: the whole x, weights, state and cotangents
    (numpy). Returns the forward outputs and the gradients of the
    cotangent-weighted sum: inputs whole, weights as this rank's
    blocks."""
    from multiverse_torch.ops import ConvLSTMState, conv2d, convlstm_step
    from multiverse_torch.parallel.tensor import leaf_shard

    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    names = ("kernel", "bias") if kind == "lstm" else ("w", "b")
    params = {}
    for n in names:
        shard = leaf_shard(mesh, n, t[n].shape)
        p = torch.nn.Parameter(t[n] if shard is None else shard.block(t[n]))
        p.shard = shard
        params[n] = p
    x = t["x"].requires_grad_(True)
    if kind == "lstm":
        d = t["c"].shape[-1] // mesh.model_parallel
        own = slice(mesh.model_index * d, (mesh.model_index + 1) * d)
        c = t["c"][..., own].clone().requires_grad_(True)
        h = t["h"].requires_grad_(True)
        out, state = convlstm_step(params, x, ConvLSTMState(c=c, h=h))
        loss = (torch.sum(out * t["cot"])
                + torch.sum(state.c * t["cot_c"][..., own]))
        loss.backward()
        grads = {"x": x.grad, "h": h.grad, "c": c.grad}
        outs = {"h": out, "c": state.c}
    else:
        out = conv2d(params, x, activation=torch.relu)
        torch.sum(out * t["cot"]).backward()
        grads, outs = {"x": x.grad}, {"out": out}
    grads.update({n: params[n].grad for n in names})
    return ({k: v.detach().numpy() for k, v in outs.items()},
            {k: v.numpy() for k, v in grads.items()}, mesh.model_collectives)


def dropout_forward(mesh, cfg, tree, batch, rng):
    """The tensor-parallel train-mode forward at ``cfg.keep_prob`` < 1 of
    this rank's shard, with the step's seed (``rank_seed``): its class
    logits and regression per scale and its loss."""
    tx = trainer.build_optimizer(cfg, 40)
    model, _ = parallel.init_sharded_train_state(params_from_jax(tree), tx,
                                                 mesh)
    shard = parallel.shard_batch(mesh, batch)
    with torch.no_grad():
        out = model_forward(model, shard, cfg, is_train=True,
                            rng=rank_seed(mesh, rng))
        loss = float(compute_loss(model, shard, out, cfg, mesh=mesh)[0])
    return parallel.map_tensors(lambda t: t.numpy(), (
        out.class_logits, out.reg_out)), loss


def tp_suite(mesh, boundaries, steps, dropout, save_dir):
    """A tensor-parallel launch's cases in one spawn: each ``boundaries``
    case, :func:`train_steps` of each ``steps`` case, :func:`dropout_forward`
    and, with ``save_dir``, a train step's gathered weights saved by
    rank 0 through ``CheckpointManager`` (every rank gathers)."""
    from multiverse_torch.train.checkpoints import CheckpointManager

    out = {"boundaries": {k: boundary(mesh, k, a)
                          for k, a in boundaries.items()},
           "steps": {k: train_steps(mesh, *a) for k, a in steps.items()}}
    if dropout is not None:
        out["dropout"] = dropout_forward(mesh, *dropout)
    if save_dir is not None:
        cfg, tree, batches, n = steps["unmasked"][:4]
        tx = trainer.build_optimizer(cfg, n)
        model, opt_state = parallel.init_sharded_train_state(
            params_from_jax(tree), tx, mesh)
        parallel.make_sharded_train_step(cfg, tx, mesh)(
            model, opt_state, parallel.shard_batch(mesh, batches[0]))
        whole = parallel.gather_params(mesh, model)
        if mesh.is_main:
            CheckpointManager(save_dir).save(1, whole)
        out["saved"] = params_to_numpy_tree(whole)
        out["block_bytes"] = sum(
            p.numel() * p.element_size() for p in model.parameters())
    return out


def tp_step_without_jax(mesh, cfg):
    """One tensor-parallel train step (seeded weights, synthetic data,
    dropout on) of this rank. Returns (its loss, the modules of jax, the
    JAX package, orbax, tensorstore or zstandard this process holds)."""
    import sys

    from multiverse_torch.data import dataset
    from multiverse_torch.models import Multiverse

    ds = dataset.dataset_from_arrays(dataset.synthesize_split(cfg, 4, seed=0),
                                     cfg, "train")
    tx = trainer.build_optimizer(cfg, 4)
    model, opt_state = parallel.init_sharded_train_state(
        Multiverse.init(cfg), tx, mesh)
    loss = float(parallel.make_sharded_train_step(cfg, tx, mesh)(
        model, opt_state, parallel.shard_batch(
            mesh, ds.make_batch([0, 1, 2, 3])[0]), 1)["total"])
    return loss, sorted(m for m in sys.modules if m.startswith(
        ("jax", "multiverse_tpu", "orbax", "tensorstore", "zstandard")))


def fail_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("planted failure on rank 1")
    mesh.all_reduce_sum(torch.ones(1))
    return mesh.rank


def hang_on_rank_1(mesh, pid_file):
    """Rank 1 writes its pid and never returns; rank 0 waits for it in a
    collective."""
    import time

    if mesh.rank == 1:
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
        while True:
            time.sleep(1)
    mesh.all_reduce_sum(torch.ones(1))
