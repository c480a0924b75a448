"""Online prediction server (PyTorch): ``mvt-torch-serve``.

Serves HTTP predictions through the dynamic-batching engine
(``multiverse_torch/serving/engine.py``) with the flags of the JAX
package's ``mvt-serve`` and its load paths: ``--random_init``,
``--load_from`` (an orbax step directory, the port's or the JAX
package's, an npz checkpoint of the port's earlier runs, or a
``save``/``best`` directory of either), or else the run
directory ``outbasepath/modelname/runId`` (its ``save`` steps, or
``best`` with ``--load_best``), written by the port or the JAX
package. The weights are pruned to the
configuration's, as the JAX package prunes a checkpoint that holds more
grid scales. ``--reload_poll_s N`` re-lists that run directory every N
seconds and swaps a newer step into the engine without dropping
traffic (a failed restore keeps the served weights), so it follows a
JAX trainer's orbax steps as ``mvt-serve`` does. Differences:

* ``--device`` picks the device (default cuda); ``--num_devices N``
  (0: every visible GPU) shards each served batch over N devices, one
  process a device (``multiverse_torch/parallel``), and fails where
  fewer are visible;
* it reads the port's earlier npz steps too (``train/checkpoints.py``).

    mvt-torch-serve out model --use_gnn --use_scene_enc \\
        --use_beam_search --beam_size 20 --diverse_beam --reload_poll_s 30

On ``cuda`` with neither --compute_dtype nor --decode_quant given, it
serves in bf16 with the int8a decode tier. max_batch defaults to 8 for
beam and 32 for --greedy (the JAX package's defaults).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional, Tuple

import torch

from multiverse_torch.cli.common import add_model_args, config_from_args
from multiverse_torch.models import Multiverse
from multiverse_torch.parallel import Mesh, launch, make_mesh
from multiverse_torch.serving.engine import ServingEngine
from multiverse_torch.serving.server import PredictionServer
from multiverse_torch.train.checkpoints import (
    list_steps,
    load_checkpoint,
    read_checkpoint_tree,
    run_dir,
)

PROG = "mvt-torch-serve"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("outbasepath", type=str)
    parser.add_argument("modelname", type=str)
    parser.add_argument("--runId", type=int, default=0)
    parser.add_argument("--load_best", action="store_true")
    parser.add_argument("--load_from", type=str, default=None,
                        help="an npz checkpoint, an orbax step directory "
                             "of the JAX package, or a save/best directory "
                             "of either (its latest step)")
    parser.add_argument("--random_init", action="store_true",
                        help="serve seeded random weights (smoke tests)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max_batch", type=int, default=None,
                        help="dynamic-batch cap (default: 8 for beam, "
                             "32 for --greedy)")
    parser.add_argument("--max_delay_ms", type=float, default=5.0)
    parser.add_argument("--max_queue", type=int, default=None,
                        help="bound on queued (not yet batched) "
                             "requests; when full, new requests get "
                             "503 + Retry-After (default: unbounded)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="devices to serve across (data-parallel "
                             "batch sharding, one process a device); "
                             "0 = all visible")
    parser.add_argument("--T_pred", type=int, default=None)
    parser.add_argument("--greedy", action="store_true",
                        help="greedy single-future decode instead of "
                             "diverse beam")
    parser.add_argument("--server_backend", default="asyncio",
                        choices=("asyncio", "threads"),
                        help="HTTP front end: one-event-loop asyncio "
                             "(default) or the ThreadingHTTPServer")
    parser.add_argument("--reload_poll_s", type=float, default=0.0,
                        help="poll the run's checkpoint dir every N "
                             "seconds and hot-swap newly saved weights "
                             "into the serving engine without dropping "
                             "traffic (0 = off; needs the run-directory "
                             "load path, not --load_from/--random_init)")
    add_model_args(parser)
    # None-sentinel defaults: argparse records whether the user gave
    # these flags (in any spelling it accepts, prefixes included), so
    # the device tier default below never re-derives it from argv
    parser.set_defaults(compute_dtype=None, decode_quant=None)
    return parser


def resolve_serving_dtypes(device_type: str, compute_dtype, decode_quant):
    """The serving tier: on ``cuda`` with neither flag given, bf16 with
    the int8a decode tier (the JAX package's accelerator default);
    otherwise the given flags, the un-given one at its library default
    (f32, no quantisation). ``None`` means the flag was not given.
    Returns ``(compute_dtype, decode_quant)``."""
    if device_type == "cuda" and compute_dtype is None \
            and decode_quant is None:
        return "bfloat16", "int8a"
    return compute_dtype or "float32", decode_quant or "none"


def resolve_max_batch(max_batch, greedy: bool) -> int:
    """The JAX package's tier defaults: 8 for beam, 32 for greedy."""
    if max_batch is not None:
        return max_batch
    return 32 if greedy else 8


def checkpoint_dir(args) -> Optional[str]:
    """The run directory's ``save`` (``best`` with --load_best) that the
    weights come from; None with --random_init or --load_from."""
    if args.random_init or args.load_from is not None:
        return None
    return os.path.join(run_dir(args.outbasepath, args.modelname,
                                args.runId),
                        "best" if args.load_best else "save")


def load_model(args, cfg) -> Tuple[Multiverse, Optional[int]]:
    """The served weights, pruned to ``cfg``'s parameters, and the step
    of the run directory they came from (None for --random_init and
    --load_from). Raises ``FileNotFoundError`` where there is no
    checkpoint."""
    template = Multiverse.init(cfg, seed=0)
    if args.random_init:
        return template, None
    if args.load_from is not None:
        return load_checkpoint(args.load_from, template), None
    directory = checkpoint_dir(args)
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError("no checkpoint in %s" % directory)
    step, path = steps[-1]
    return load_checkpoint(path, template), step


def reload_once(engine: ServingEngine, directory: str,
                served_step: Optional[int]) -> Optional[int]:
    """One poll of the hot reload: list ``directory`` afresh and, when
    its latest step is not the served one, load it and swap it into
    ``engine`` (``update_params`` prunes it to the served model). A
    failed restore keeps the served weights and is retried at the next
    poll. Returns the step served after the poll."""
    try:
        steps = list_steps(directory)
        if not steps or steps[-1][0] == served_step:
            return served_step
        step, path = steps[-1]
        engine.update_params(read_checkpoint_tree(path))
    except Exception as exc:   # keep serving the old weights
        print(f"{PROG}: reload failed ({exc}); keeping current weights",
              file=sys.stderr)
        return served_step
    print(f"{PROG}: hot-reloaded checkpoint step {step}", file=sys.stderr)
    return step


def reload_loop(engine: ServingEngine, directory: str,
                served_step: Optional[int], poll_s: float,
                stop: threading.Event) -> None:
    """:func:`reload_once` every ``poll_s`` seconds until ``stop``."""
    while not stop.wait(poll_s):
        served_step = reload_once(engine, directory, served_step)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    mesh = None
    if args.num_devices != 1:
        try:
            mesh = make_mesh(n_devices=args.num_devices or None,
                             device_type=device.type)
        except ValueError as exc:
            raise SystemExit(f"{PROG}: --num_devices {args.num_devices}: "
                             f"{exc}") from None
    args.compute_dtype, args.decode_quant = resolve_serving_dtypes(
        device.type, args.compute_dtype, args.decode_quant)
    args.max_batch = resolve_max_batch(args.max_batch, args.greedy)
    if args.reload_poll_s > 0 and checkpoint_dir(args) is None:
        raise SystemExit(f"{PROG}: --reload_poll_s needs the run-directory "
                         "load path (drop --load_from/--random_init)")
    if mesh is None:
        serve_rank(None, args)
    else:
        launch(serve_rank, mesh, args)


def serve_rank(mesh: Optional[Mesh], args: argparse.Namespace) -> None:
    """The server on one device (``mesh`` None), or one rank of it: rank
    0 serves HTTP, warms up and hot-reloads (each update reaches every
    rank through ``update_params``); the other ranks decode their block
    of each batch until rank 0 closes."""
    cfg = config_from_args(args).replace(
        use_beam_search=not args.greedy).validate()
    reload_dir = checkpoint_dir(args)
    model, served_step = load_model(args, cfg)

    engine = ServingEngine(
        model, cfg, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, T_pred=args.T_pred,
        max_queue=args.max_queue, device=args.device, mesh=mesh)
    if mesh is not None and not mesh.is_main:
        engine.run_worker()
        return
    print(f"{PROG}: warming up (batch={args.max_batch}, "
          f"T={engine.T_pred}, beam={cfg.beam_size}, "
          f"dtype={cfg.compute_dtype}, quant={cfg.decode_quant}, "
          f"device={engine.device}"
          + ("" if mesh is None or mesh.group is None
             else f", mesh={mesh.shape} {mesh.backend}")
          + ")...", file=sys.stderr)
    dt = engine.warmup()
    print(f"{PROG}: warm in {dt:.1f}s", file=sys.stderr)

    stop_reload = threading.Event()
    if args.reload_poll_s > 0:
        threading.Thread(
            target=reload_loop, name="mvt-serve-reload", daemon=True,
            args=(engine, reload_dir, served_step, args.reload_poll_s,
                  stop_reload)).start()

    if args.server_backend == "asyncio":
        from multiverse_torch.serving.aserver import AsyncPredictionServer

        server = AsyncPredictionServer(engine, host=args.host,
                                       port=args.port)
        server.start_background()   # binds + reports the port
    else:
        server = PredictionServer(engine, host=args.host, port=args.port)
    print(f"{PROG}: listening on http://{args.host}:{server.port} "
          f"({args.server_backend})", file=sys.stderr)

    def _sigterm(*_):
        # containers stop with SIGTERM: drain and close instead of
        # dying mid-batch with waiters stranded
        raise SystemExit(0)

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _sigterm)
    try:
        if args.server_backend == "asyncio":
            server.wait()
        else:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop_reload.set()
        server.close()


if __name__ == "__main__":
    main()
