"""mvt-torch-preprocess: the port's offline featurisation command.

The counterpart of ``mvt-preprocess`` (``multiverse_tpu/cli/
preprocess.py``; reference: code/preprocess.py:22-78), with the same
flags: turns per-video trajectory TSVs into data_{train,val,test}.npz
with grid labels, dense regression targets and scene-semantic
features, equal to what ``mvt-preprocess`` writes. Host numpy, as in
the JAX package, so it takes no ``--device``.

    mvt-torch-preprocess traj_2.5fps prepro --add_grid --add_all_reg \\
        --add_scene --scene_feat_path scene_seg \\
        --scene_id2name scene36_64_id2name_top10.json \\
        --direct_scene_feat --grid_strides 2,4 --obs_len 8 --pred_len 12
"""

from __future__ import annotations

import argparse
import os

from multiverse_torch.data.preprocess import (
    PreprocessOptions,
    preprocess_split,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mvt-torch-preprocess", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("traj_path")
    parser.add_argument("out_path")
    parser.add_argument("--obs_len", type=int, default=8)
    parser.add_argument("--pred_len", type=int, default=12)
    parser.add_argument("--min_ped", type=int, default=0)
    parser.add_argument("--add_grid", action="store_true")
    parser.add_argument("--add_all_reg", action="store_true")
    parser.add_argument("--add_scene", action="store_true")
    parser.add_argument("--add_kp", action="store_true")
    parser.add_argument("--add_person_box", action="store_true")
    parser.add_argument("--add_other_box", action="store_true")
    parser.add_argument("--add_activity", action="store_true")
    parser.add_argument("--scene_feat_path", default=None)
    parser.add_argument("--scene_map_path", default=None)
    parser.add_argument("--scene_id2name", default=None)
    parser.add_argument("--direct_scene_feat", action="store_true")
    parser.add_argument("--kp_path", default=None)
    parser.add_argument("--person_box_path", default=None)
    parser.add_argument("--person_boxkey2id_p", default=None)
    parser.add_argument("--other_box_path", default=None)
    parser.add_argument("--activity_path", default=None)
    parser.add_argument("--scene_h", type=int, default=36)
    parser.add_argument("--scene_w", type=int, default=64)
    parser.add_argument("--video_h", type=int, default=1080)
    parser.add_argument("--video_w", type=int, default=1920)
    parser.add_argument("--grid_strides", default="2,4")
    parser.add_argument("--feature_no_split", action="store_true")
    parser.add_argument("--reverse_xy", action="store_true")
    parser.add_argument("--traj_pixel_lst", default=None)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    opts = PreprocessOptions(**{
        k: v for k, v in vars(args).items()
        if k not in ("traj_path", "out_path")})
    for split in ("train", "val", "test"):
        preprocess_split(
            args.traj_path, split,
            os.path.join(args.out_path, "data_%s.npz" % split), opts)


if __name__ == "__main__":
    main()
