"""Multi-future inference command (PyTorch): Forking Paths obs -> K
trajectories.

Same arguments and output pickles as ``mvt-multifuture-inference``
(``--greedy`` decodes one future and writes it ``--num_out`` times;
``--decode_quant int8|int8a|int8_dyn`` runs the int8 tiers' kernels).
``model_path`` is an npz checkpoint of the port, an orbax step
directory of the JAX package (``<save>/<step>``), or a ``save``/``best``
directory of either (its latest step), pruned to the configuration's parameters
as the JAX package prunes a checkpoint that holds more grid scales.
Three additions: ``--device`` picks the device (default cuda),
``--random_init`` decodes seeded random weights (seed 0) instead of
reading ``model_path`` (smoke tests), and ``--profile DIR`` traces the
decode with ``torch.profiler``: ``DIR/trace.json`` (a Chrome trace that
holds the program's spans as ranges) and ``DIR/spans.json`` (each span's
count, total and self seconds, the counters, the spans dropped).
"""

from __future__ import annotations

import argparse

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.inference import (
    load_multifuture_inputs,
    run_multifuture_inference,
    save_outputs,
)
from multiverse_torch.models import Multiverse
from multiverse_torch.train.checkpoints import load_checkpoint
from multiverse_torch.utils import profile_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_path",
                        help="npz checkpoint, orbax step directory of the "
                        "JAX package, or a save/best directory of either")
    parser.add_argument("traj_path", help="obs trajectory TSVs")
    parser.add_argument("multifuture_path", help="GT future pickles")
    parser.add_argument("output_file")
    parser.add_argument("--random_init", action="store_true",
                        help="decode seeded random weights (seed 0); "
                             "model_path is not read")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--save_prob_file", default=None)
    parser.add_argument("--prob_fetch_dtype", default="float32",
                        choices=["float32", "float16"])
    parser.add_argument("--obs_length", type=int, default=8)
    parser.add_argument("--num_out", type=int, default=20)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--center_only", action="store_true")
    parser.add_argument("--diverse_beam", action="store_true")
    parser.add_argument("--diverse_gamma", type=float, default=1.0)
    parser.add_argument("--fix_num_timestep", type=int, default=0)
    parser.add_argument("--grid_strides", default="2,4")
    parser.add_argument("--use_grids", default="1,0")
    parser.add_argument("--emb_size", type=int, default=32)
    parser.add_argument("--enc_hidden_size", type=int, default=256)
    parser.add_argument("--dec_hidden_size", type=int, default=256)
    parser.add_argument("--scene_conv_kernel", type=int, default=3)
    parser.add_argument("--scene_conv_dim", type=int, default=64)
    parser.add_argument("--convlstm_kernel", type=int, default=3)
    parser.add_argument("--use_gnn", action="store_true")
    parser.add_argument("--use_scene_enc", action="store_true")
    parser.add_argument("--use_single_decoder", action="store_true")
    parser.add_argument("--use_soft_grid_class", action="store_true")
    parser.add_argument("--norm_input", action="store_true")
    parser.add_argument("--scene_feat_path", default=None)
    parser.add_argument("--scene_id2name", default=None)
    parser.add_argument("--scene_h", type=int, default=36)
    parser.add_argument("--scene_w", type=int, default=64)
    parser.add_argument("--scene_class", type=int, default=11)
    parser.add_argument("--video_h", type=int, default=1080)
    parser.add_argument("--video_w", type=int, default=1920)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--decode_quant", default="none",
                        choices=["none", "int8", "int8a", "int8_dyn"],
                        help="int8 tier of the fused decode step (with "
                             "--compute_dtype bfloat16): 'int8' int8 gate "
                             "product, 'int8a' int8 attention too, "
                             "'int8_dyn' two int8 gate products, the "
                             "recurrent one at per-row dynamic scales")
    parser.add_argument("--beam_select", default="twostage",
                        choices=["twostage", "dense"])
    parser.add_argument("--profile", default=None,
                        help="directory for a torch.profiler trace of the "
                             "decode and its spans")
    return parser


def load_model(model_path: str, cfg: MultiverseConfig,
               random_init: bool = False) -> Multiverse:
    """The decoded weights: ``model_path``'s, pruned to ``cfg``'s
    parameters, or seeded random ones with ``random_init``."""
    template = Multiverse.init(cfg, seed=0)
    if random_init:
        return template
    return load_checkpoint(model_path, template)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    prog = "mvt-torch-multifuture-inference"
    if args.greedy and args.save_prob_file:
        # greedy has no beams, so the .prob.p contract cannot be produced
        raise SystemExit(f"{prog}: --save_prob_file requires beam search; "
                         "drop --greedy")
    cfg = MultiverseConfig(
        obs_len=args.obs_length,
        emb_size=args.emb_size,
        enc_hidden_size=args.enc_hidden_size,
        dec_hidden_size=args.dec_hidden_size,
        scene_conv_kernel=args.scene_conv_kernel,
        scene_conv_dim=args.scene_conv_dim,
        convlstm_kernel=args.convlstm_kernel,
        use_gnn=args.use_gnn,
        use_scene_enc=args.use_scene_enc,
        use_single_decoder=args.use_single_decoder,
        use_soft_grid_class=args.use_soft_grid_class,
        norm_input=args.norm_input,
        scene_h=args.scene_h,
        scene_w=args.scene_w,
        scene_class=args.scene_class,
        video_h=args.video_h,
        video_w=args.video_w,
        beam_size=args.num_out,
        use_beam_search=not args.greedy,
        diverse_beam=args.diverse_beam,
        diverse_gamma=args.diverse_gamma,
        fix_num_timestep=args.fix_num_timestep,
        compute_dtype=args.compute_dtype,
        decode_quant=args.decode_quant,
        beam_select=args.beam_select,
        **MultiverseConfig.parse_strides(args.grid_strides, args.use_grids),
    ).validate()

    inputs = load_multifuture_inputs(
        args.traj_path, args.multifuture_path,
        args.scene_feat_path, args.scene_id2name, cfg)
    print("loaded %d trajectories" % len(inputs.traj_ids))

    model = load_model(args.model_path, cfg, args.random_init)
    with profile_trace(args.profile):
        output_data, beam_prob = run_multifuture_inference(
            model, inputs, cfg,
            batch_size=args.batch_size,
            greedy=args.greedy,
            center_only=args.center_only,
            need_prob=args.save_prob_file is not None,
            prob_fetch_dtype=args.prob_fetch_dtype,
            device=args.device,
        )
    save_outputs(output_data, beam_prob,
                 args.output_file, args.save_prob_file)
    print("wrote %s" % args.output_file)


if __name__ == "__main__":
    main()
