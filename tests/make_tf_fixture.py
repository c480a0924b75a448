"""Writes ``tests/torch_fixtures/tf_ckpt``: a TF1 checkpoint (a V2
tensor bundle, as ``tf.compat.v1.train.Saver`` writes it) with the
reference's variable names, for the port's bundle reader and converter.

    python tests/make_tf_fixture.py

Needs tensorflow; not a test module. The model is :func:`fixture_config`
(``chip_smoke.TF_FIXTURE_WIDTHS``: D 32, E 16, scene_conv_dim 16, the
18x32 grid of scale 0, use_grids 1,0, scene encoder and GNN on: 210,816
parameters), cut from the published widths because a bundle is
uncompressed (the published use_grids 1,0 model is 42.8 MB).
Its weights are ``chip_smoke.fixture_leaf`` of each parameter's name in
the port (``scales/0/dec_class/kernel``), so the checks remake them and
no expected value is stored. Beside them: ``global_step`` (int64) and
the Adadelta slots (``<name>/Adadelta``, ``<name>/Adadelta_1``) of every
variable but the four ConvLSTM kernels, whose slots would take the
bundle past 1 MB.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import TF_FIXTURE as OUT  # noqa: E402
from chip_smoke import TF_FIXTURE_WIDTHS, fixture_leaf  # noqa: E402

STEP = 120000

# the released checkpoints' variable names (tests/test_tf_converter.py)
# and the port's parameter each holds, for grid scale 0
REFERENCE_NAMES = {
    "person_pred/scene_conv1/W": "scene_conv1/w",
    "person_pred/scene_conv1/b": "scene_conv1/b",
    "person_pred/scene_conv2/W": "scene_conv2/w",
    "person_pred/scene_conv2/b": "scene_conv2/b",
    "person_pred/encoder_grid_class_0/enc_grid_0/kernel":
        "scales/0/enc_class/kernel",
    "person_pred/encoder_grid_class_0/enc_grid_0/biases":
        "scales/0/enc_class/bias",
    "person_pred/encoder_grid_reg_0/enc_grid_regress_0/kernel":
        "scales/0/enc_reg/kernel",
    "person_pred/encoder_grid_reg_0/enc_grid_regress_0/biases":
        "scales/0/enc_reg/bias",
    "person_pred/decoder_grid_class_0/decoder_rnn/dec_grid_0/kernel":
        "scales/0/dec_class/kernel",
    "person_pred/decoder_grid_class_0/decoder_rnn/dec_grid_0/biases":
        "scales/0/dec_class/bias",
    "person_pred/decoder_grid_reg_0/decoder_rnn/dec_grid_reg_0/kernel":
        "scales/0/dec_reg/kernel",
    "person_pred/decoder_grid_reg_0/decoder_rnn/dec_grid_reg_0/biases":
        "scales/0/dec_reg/bias",
    "person_pred/decoder_grid_class_0/decoder_rnn/grid_emb/W":
        "scales/0/dec_class_emb/w",
    "person_pred/decoder_grid_class_0/decoder_rnn/grid_emb/b":
        "scales/0/dec_class_emb/b",
    "person_pred/decoder_grid_reg_0/decoder_rnn/grid_emb/W":
        "scales/0/dec_reg_emb/w",
    "person_pred/decoder_grid_reg_0/decoder_rnn/grid_emb/b":
        "scales/0/dec_reg_emb/b",
    "person_pred/hidden2grid_decoder_grid_class_0/out_dec_grid/W":
        "scales/0/h2g_class/w",
    "person_pred/hidden2grid_decoder_grid_reg_0/out_dec_grid/W":
        "scales/0/h2g_reg/w",
}


def fixture_config():
    from multiverse_torch.config import MultiverseConfig

    return MultiverseConfig(use_grids=(True, False), use_scene_enc=True,
                            use_gnn=True, **TF_FIXTURE_WIDTHS).validate()


def fixture_tensors(slots_limit: int = 1 << 14) -> dict:
    """TF name -> value: the weights, the Adadelta slots of every
    variable of at most ``slots_limit`` values, and global_step."""
    from multiverse_torch.models import Multiverse

    shapes = {n.replace(".", "/"): tuple(p.shape) for n, p in
              Multiverse.init(fixture_config()).named_parameters()}
    if sorted(shapes) != sorted(REFERENCE_NAMES.values()):
        raise SystemExit("the fixture's names differ from the model's")
    out = {}
    for name, port in REFERENCE_NAMES.items():
        out[name] = fixture_leaf(port, shapes[port])
        if np.prod(shapes[port]) <= slots_limit:
            for slot in ("Adadelta", "Adadelta_1"):
                out[name + "/" + slot] = np.abs(fixture_leaf(
                    name + "/" + slot, shapes[port]))
    out["global_step"] = np.int64(STEP)
    return out


def write_bundle(directory: str, tensors: dict, step: int,
                 sharded: bool = False) -> str:
    """``tensors`` (TF name -> numpy value) saved by a graph-mode
    ``tf.compat.v1.train.Saver`` as ``<directory>/model-<step>``, the
    ``checkpoint`` file naming it relative to the directory. With
    ``sharded``, the variables alternate between two CPU devices and the
    Saver writes one data file each. Returns the prefix."""
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import tensorflow as tf

    os.makedirs(directory, exist_ok=True)
    graph = tf.Graph()
    with graph.as_default():
        for i, (name, value) in enumerate(sorted(tensors.items())):
            with tf.device("/cpu:%d" % (i % 2 if sharded else 0)):
                tf.compat.v1.Variable(value, name=name)
        saver = tf.compat.v1.train.Saver(sharded=sharded,
                                         save_relative_paths=True)
        config = tf.compat.v1.ConfigProto(device_count={"CPU": 2})
        with tf.compat.v1.Session(config=config) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            return saver.save(sess, os.path.join(directory, "model"),
                              global_step=step, write_meta_graph=False)


def main() -> None:
    import shutil

    shutil.rmtree(OUT, ignore_errors=True)
    prefix = write_bundle(OUT, fixture_tensors(), STEP)
    size = sum(os.path.getsize(os.path.join(OUT, f))
               for f in os.listdir(OUT))
    print("wrote %s (%d files, %d bytes)" % (prefix, len(os.listdir(OUT)),
                                              size))


if __name__ == "__main__":
    main()
