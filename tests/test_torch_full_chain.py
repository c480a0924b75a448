"""The port's Forking Paths workflow L0 -> L6 with its own commands, at
``tests/test_full_chain.py``'s toy scale (``tests/torch_chain.py``):

fake-CARLA record (palette seg MP4s + bbox JSONs) with
``mvt-torch-record-moments`` -> frames and scene class maps
(``extract_frames_and_seg``) -> multi-future and anchor preparation ->
``mvt-torch-preprocess`` -> ``mvt-torch-train`` (2 epochs, CPU) ->
``mvt-torch-multifuture-inference`` (K = 3) -> both evaluators.

Beside the JAX package: the JAX package's steps run on the same moments
(over ``tests/fake_carla.py``, the port's over
``tests/torch_fake_carla.py``, ids reset before each) and everything up
to and including the preprocessed npz is equal at tolerance 0 (bbox and
moment JSONs, frame jpgs, scene npys, TSVs byte-equal; GT pickles and
npz equal after loading, types included; videos by decoded frames). The
two packages' trainings start from different random weights and are
not compared; instead the JAX ``mvt-multifuture-inference`` decodes the
port's best checkpoint and its trajectories must agree with the port's
within rtol 1e-4, atol 1e-3 (the tolerance of
``tests/test_torch_train_cli.py``'s JAX-forward check of a port
checkpoint). A second case runs the port's chain in a subprocess with
jax, the JAX package, orbax, tensorstore, zstandard, tensorflow, pygame
and transformers unimportable."""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

from test_torch_train_cli import one_torch_thread  # noqa: F401
from tests import torch_chain
from tests.toolkit_parity import install_fake, same, same_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_steps():
    from multiverse_tpu.cli import preprocess
    from multiverse_tpu.cli.vis_dataset import record_moments_main
    from multiverse_tpu.forking_paths import controls, prepared_data

    return types.SimpleNamespace(
        controls=controls, prepared=prepared_data,
        record_moments_main=record_moments_main,
        preprocess_main=preprocess.main)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("full_chain"))
    out = {}
    for name, steps in (("multiverse_tpu", _jax_steps),
                        ("multiverse_torch", torch_chain.port_steps)):
        side = os.path.join(root, name)
        os.makedirs(side)
        install_fake(name)
        try:
            out[name] = torch_chain.record_and_prepare(steps(), side)
        finally:
            sys.modules.pop("carla", None)
    return root, out


def test_recorded_to_preprocessed_files_equal_jax(chains):
    root, paths = chains
    port, jax = (os.path.join(root, n) for n in ("multiverse_torch",
                                                  "multiverse_tpu"))
    npz = [os.path.join("prepro", "data_%s.npz" % s)
           for s in ("train", "val", "test")]
    for rel in npz:
        with np.load(os.path.join(port, rel), allow_pickle=True) as got, \
                np.load(os.path.join(jax, rel), allow_pickle=True) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                same(_plain_npz(got[key]), _plain_npz(want[key]),
                     "%s:%s" % (rel, key))
    n = same_tree(port, jax, skip=npz)
    # registry, moments, 3 x (rgb, seg, bbox), frames, npys, TSVs, pickles
    assert n > 40


def _plain_npz(a):
    """Object arrays element by element (their pickled items)."""
    if isinstance(a, np.ndarray) and a.dtype == object:
        return [_plain_npz(x) for x in a.ravel()]
    return a


def test_port_chain_scores_and_jax_decodes_its_checkpoint(chains, capsys):
    from multiverse_tpu.cli import multifuture_inference as jax_inference

    root, paths = chains
    port_root = os.path.join(root, "multiverse_torch")
    p = paths["multiverse_torch"]
    out = torch_chain.train_decode_score(port_root, p)
    jax_traj = os.path.join(port_root, "jax_decode.traj.p")
    jax_inference.main([out["best"], p["obs"], p["mf"], jax_traj,
                        *torch_chain.inference_flags(p)])
    capsys.readouterr()
    with open(jax_traj, "rb") as f:
        jax_preds = pickle.load(f)
    assert sorted(jax_preds) == sorted(out["preds"])
    for key, want in jax_preds.items():
        np.testing.assert_allclose(np.asarray(out["preds"][key]),
                                   np.asarray(want), rtol=1e-4, atol=1e-3)


BLOCKED = ("jax", "jaxlib", "multiverse_tpu", "orbax", "tensorstore",
           "zstandard", "tensorflow", "pygame", "transformers")


def test_port_chain_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import torch_chain, torch_fake_carla\n"
        "torch_fake_carla.install()\n"
        "paths = torch_chain.record_and_prepare(torch_chain.port_steps(),\n"
        "                                       %r)\n"
        "out = torch_chain.train_decode_score(%r, paths)\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in %r)\n"
        "print('SCORES', out['ade_fde'], out['nll'])\n"
        "print('BLOCKED_MODULES', bad)\n"
        % (BLOCKED, str(tmp_path), str(tmp_path), BLOCKED))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "BLOCKED_MODULES []" in proc.stdout
    assert "SCORES" in proc.stdout
