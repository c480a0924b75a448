"""mvt-torch-eval-prob: grid NLL evaluation from beam probabilities.

reference: code/multifuture_eval_trajs_prob.py — same positional args
and print format.

The port's counterpart of ``mvt-eval-prob`` (numpy only, no jax).
"""

from __future__ import annotations

import argparse
import pickle

from multiverse_torch.eval.multifuture import evaluate_multifuture_nll


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("gt_path")
    parser.add_argument("prediction_file")
    parser.add_argument("--scene_h", type=int, default=18)
    parser.add_argument("--scene_w", type=int, default=32)
    parser.add_argument("--video_h", type=int, default=1080)
    parser.add_argument("--video_w", type=int, default=1920)
    args = parser.parse_args(argv)

    with open(args.prediction_file, "rb") as f:
        predictions = pickle.load(f)

    time_list = (0, 1, 2, 3, 4)
    out = evaluate_multifuture_nll(
        predictions, args.gt_path,
        scene_h=args.scene_h, scene_w=args.scene_w,
        video_h=args.video_h, video_w=args.video_w,
        time_list=time_list)

    # print format (reference: code/multifuture_eval_trajs_prob.py:111-116)
    keys = sorted("T=%d" % (t + 1) for t in time_list)
    print([out["count_%s" % k] for k in keys])
    print("NLL:")
    print(" ".join(keys))
    print(" ".join(["%s" % out["nll_%s" % k] for k in keys]))


if __name__ == "__main__":
    main()
