"""mvt-torch-convert-tf — convert a released reference TF1 checkpoint
into the run layout that the port's and the JAX package's commands read
(orbax steps), with no tensorflow, jax or orbax installed.

The port's copy of ``mvt-convert-tf`` (``multiverse_tpu/cli/
convert_tf.py``), with its arguments and printed line:

    mvt-torch-convert-tf <tf_ckpt_prefix> <outbasepath> <modelname> \
        <runId> [--non_strict] [model flags as in mvt-torch-train]

The TF prefix is what ``tf.train.latest_checkpoint`` returns, e.g.
``.../multiverse_single18.51.../save/model-120000`` (reference restore
logic: code/pred_utils.py:149-205), or the directory holding its
``checkpoint`` file. The bundle is read by
``multiverse_torch/tools/tf_bundle.py``, the names mapped by
``tools/tf_converter.py``; the weights are saved as step 0 of the run
directory's ``save`` and ``best``.
"""

from __future__ import annotations

import argparse

from multiverse_torch.cli import common


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="mvt-torch-convert-tf")
    parser.add_argument("tf_ckpt", help="TF checkpoint prefix "
                                        "(…/save/model-XXXX)")
    parser.add_argument("outbasepath")
    parser.add_argument("modelname")
    parser.add_argument("runId", type=int)
    parser.add_argument("--non_strict", action="store_true",
                        help="ignore checkpoint variables that don't "
                             "exist under this config")
    common.add_model_args(parser)
    args = parser.parse_args(argv)

    from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
    from multiverse_torch.models import Multiverse
    from multiverse_torch.tools.tf_converter import convert_tf_checkpoint
    from multiverse_torch.train.checkpoints import (
        CheckpointManager,
        process_out_dirs,
    )

    cfg = common.config_from_args(args)
    template = params_to_numpy_tree(Multiverse.init(cfg))
    params = params_from_jax(convert_tf_checkpoint(
        args.tf_ckpt, cfg, template, strict=not args.non_strict))

    outpath = process_out_dirs(args.outbasepath, args.modelname,
                               args.runId)
    manager = CheckpointManager(outpath)
    manager.save(0, params)
    manager.save(0, params, best=True)
    print("converted %s -> %s (step 0, save+best)"
          % (args.tf_ckpt, outpath))


if __name__ == "__main__":
    main()
