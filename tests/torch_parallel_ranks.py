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
    """The data-parallel step over ``batches`` (host Batches) from the
    weights ``tree``. Returns (per-step losses, final weights as a numpy
    tree, this rank's collective calls)."""
    tx = trainer.build_optimizer(cfg, num_examples)
    model, opt_state = parallel.init_sharded_train_state(
        params_from_jax(tree), tx, mesh)
    step = parallel.make_sharded_train_step(cfg, tx, mesh)
    losses = []
    for i, batch in enumerate(batches):
        parts = step(model, opt_state, parallel.shard_batch(mesh, batch),
                     None if rngs is None else rngs[i])
        losses.append({k: float(v) for k, v in parts.items()})
    return losses, params_to_numpy_tree(model), mesh.collectives


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
