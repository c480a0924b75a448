"""mvt-torch-eval-trajs: minADE/minFDE over multi-future predictions.

reference: code/multifuture_eval_trajs.py — same positional args and
print format, so published commands carry over.

The port's counterpart of ``mvt-eval-trajs`` (numpy only, no jax).
"""

from __future__ import annotations

import argparse
import pickle

from multiverse_torch.eval.multifuture import evaluate_multifuture_trajs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("gt_path")
    parser.add_argument("prediction_file")
    args = parser.parse_args(argv)

    with open(args.prediction_file, "rb") as f:
        prediction = pickle.load(f)

    out = evaluate_multifuture_trajs(prediction, args.gt_path)

    # print format (reference: code/multifuture_eval_trajs.py:80-85)
    print("ADE/FDE:")
    keys = ["45-degree", "top-down", "all"]
    print(" ".join(keys + keys))
    print(" ".join(["%s" % out["minade_%s" % k] for k in keys]
                   + ["%s" % out["minfde_%s" % k] for k in keys]))


if __name__ == "__main__":
    main()
