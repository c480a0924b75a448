"""Writes ``tests/torch_fixtures/jax_run/``: a run directory saved by the
JAX package's own ``CheckpointManager`` (``multiverse/00/save/<STEP>/``,
orbax over OCDBT and zstd-compressed zarr) of the published model with
both grid scales (``MultiverseConfig(use_grids=(True, True))``,
21,337,728 parameters).

The leaves are not ``init_params``' values but ``chip_smoke.fixture_leaf``'s,
made from a seed and each leaf's name (``scales/0/dec_class/kernel``):
blocks drawn from a small codebook for the large leaves, so the step
takes a few MB where random weights take 79 MB, and plain random weights
for the small ones. No expected values are stored: ``chip_smoke.py``
(phase 10, on the card's machine, where neither JAX nor orbax,
tensorstore or zstandard exists) and the tests remake them with the same
function.

    JAX_PLATFORMS=cpu python tests/make_jax_fixture.py

Not a test module: it needs JAX and rewrites the committed fixture.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import FIXTURE_GRIDS, JAX_FIXTURE, fixture_leaf  # noqa: E402
from multiverse_tpu.config import MultiverseConfig  # noqa: E402
from multiverse_tpu.models import init_params  # noqa: E402
from multiverse_tpu.train.checkpoints import (  # noqa: E402
    CheckpointManager,
    process_out_dirs,
)

STEP = 120


def main() -> None:
    cfg = MultiverseConfig(use_gnn=True, use_scene_enc=True,
                           use_grids=FIXTURE_GRIDS).validate()
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(fixture_leaf(
            "/".join(str(k.key) for k in path), v.shape)),
        init_params(jax.random.PRNGKey(0), cfg))
    shutil.rmtree(JAX_FIXTURE, ignore_errors=True)
    run = process_out_dirs(JAX_FIXTURE, "multiverse", 0)
    CheckpointManager(run).save(STEP, params)
    leaves = jax.tree_util.tree_leaves(params)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(JAX_FIXTURE) for f in fs)
    print("wrote %s: %d leaves, %d parameters, %d bytes"
          % (JAX_FIXTURE, len(leaves), sum(v.size for v in leaves), size))


if __name__ == "__main__":
    main()
