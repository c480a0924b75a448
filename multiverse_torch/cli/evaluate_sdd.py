"""mvt-torch-evaluate-sdd: Stanford-Drone rescaled ADE/FDE evaluation.

reference: SimAug/code/evaluate_sdd.py — same args and print format.

The port's counterpart of ``mvt-evaluate-sdd`` (numpy only, no jax).
"""

from __future__ import annotations

import argparse

from multiverse_torch.eval.sdd import evaluate_sdd


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("changelst", help="the resize records")
    parser.add_argument("outp")
    parser.add_argument("--eval_grid", type=int, default=0)
    args = parser.parse_args(argv)

    out = evaluate_sdd(args.outp, args.changelst, eval_grid=args.eval_grid)
    print("grid %s, ade/fde %s,%s, scale_changes %.5f" % (
        args.eval_grid, out["ade"], out["fde"], out["scale_changes"]))


if __name__ == "__main__":
    main()
