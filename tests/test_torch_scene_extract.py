"""The port's scene-segmentation extraction (``data/scene_extract.py``
and ``mvt-torch-extract-scene-seg``) against the JAX package's on the
CPU: ``resize_seg_map`` and ``segment_images`` on the cases of
``tests/test_data_preps.py`` and on seeded class maps; both commands
over the same frame jpgs with a random SegFormer built here from a
small ``SegformerConfig`` (the port's on ``--device cpu``) and with a
one-op DeepLab graph of the ``ImageTensor:0 -> SemanticPredictions:0``
signature, under ``--keep_full``, ``--save_two_level``, ``--every`` and
``--job/--curJob``. Tolerance 0: every ``.npy`` byte-equal and the
printed lines equal. Also: the command stops with an ImportError
naming cv2, tensorflow (a ``.pb``) or transformers (a SegFormer
directory) where that package does not import, having written
nothing. tensorflow and transformers are imported in module fixtures,
never at collection."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from multiverse_torch.cli import prepare_data as port_cli
from multiverse_torch.data import scene_extract as port
from multiverse_tpu.cli import prepare_data as jax_cli
from multiverse_tpu.data import scene_extract as jax_se
from test_torch_train_cli import one_torch_thread  # noqa: F401
from tests.toolkit_parity import files, same


def _write_frames(root, videos=2, frames=5, h=36, w=64):
    import cv2

    rng = np.random.RandomState(3)
    os.makedirs(root, exist_ok=True)
    out = []
    for v in range(videos):
        for f in range(frames):
            path = os.path.join(root, "video%d_F_%08d.jpg" % (v, f))
            cv2.imwrite(path, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            out.append(path)
    return out


# ------------------------------------------------------------- functions


@pytest.mark.parametrize("down_rate,keep_full", [
    (2.0, False), (8.0, False), (3.0, False), (8.0, True)])
def test_resize_seg_map_equals_jax(down_rate, keep_full):
    seg = np.random.RandomState(0).randint(0, 150, (64, 96))
    got = port.resize_seg_map(seg, down_rate, keep_full=keep_full)
    same(got, jax_se.resize_seg_map(seg, down_rate, keep_full=keep_full))
    if keep_full:
        assert got.shape == (288, 512)
    else:
        assert got.shape == (int(64 / down_rate), int(96 / down_rate))


def test_resize_seg_map_case():
    seg = np.arange(64 * 64).reshape(64, 64) % 7
    assert port.resize_seg_map(seg, down_rate=2.0).shape == (32, 32)
    assert port.resize_seg_map(seg, 8.0, keep_full=True).shape == (288, 512)


def _fake_segmenter(img):
    return (img[:, :, 0] // 40).astype(np.uint8)


def _segment(module, root, img_files, **kw):
    written = module.segment_images(img_files, _fake_segmenter, root, **kw)
    return [os.path.relpath(w, root) for w in written]


@pytest.mark.parametrize("kw", [
    {"down_rate": 2.0, "save_two_level": True},
    {"down_rate": 4.0, "every": 2},
    {"keep_full": True},
    {"job": 3, "cur_job": 2},
    {"job": 2, "cur_job": 1, "save_two_level": True, "every": 3},
], ids=["two_level", "every", "keep_full", "job", "all"])
def test_segment_images_equals_jax(kw, tmp_path):
    img_files = _write_frames(str(tmp_path / "frames"))
    got = _segment(port, str(tmp_path / "port"), img_files, **kw)
    want = _segment(jax_se, str(tmp_path / "jax"), img_files, **kw)
    assert got == want and got
    _same_npys(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_segment_images_case(tmp_path):
    import cv2

    img_files = []
    for i in range(4):
        p = str(tmp_path / ("video1_F_%08d.jpg" % i))
        cv2.imwrite(p, np.zeros((36, 64, 3), np.uint8))
        img_files.append(p)

    def five(img):
        return np.full(img.shape[:2], 5, np.uint8)

    written = port.segment_images(img_files, five, str(tmp_path / "seg"),
                                  down_rate=2.0, save_two_level=True)
    assert len(written) == 4
    arr = np.load(written[0])
    assert arr.shape == (18, 32) and (arr == 5).all()
    assert "video1" in os.path.dirname(written[0])
    w1 = port.segment_images(img_files, five, str(tmp_path / "seg2"),
                             job=2, cur_job=1)
    w2 = port.segment_images(img_files, five, str(tmp_path / "seg2"),
                             job=2, cur_job=2)
    assert len(w1) + len(w2) == 4


def _same_npys(got, want):
    names = files(want)
    assert files(got) == names and names
    for name in names:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


# -------------------------------------------------------------- commands


@pytest.fixture(scope="module")
def segformer_dir(tmp_path_factory):
    """A random SegFormer (seeded) saved with its image processor."""
    from transformers import (
        SegformerConfig,
        SegformerForSemanticSegmentation,
        SegformerImageProcessor,
    )

    path = str(tmp_path_factory.mktemp("segformer"))
    torch.manual_seed(0)
    cfg = SegformerConfig(
        num_encoder_blocks=2, depths=[1, 1], sr_ratios=[2, 1],
        hidden_sizes=[8, 16], num_attention_heads=[1, 2],
        decoder_hidden_size=16, num_labels=6, patch_sizes=[7, 3],
        strides=[4, 2], mlp_ratios=[2, 2])
    SegformerForSemanticSegmentation(cfg).eval().save_pretrained(path)
    SegformerImageProcessor(size={"height": 64, "width": 64}).save_pretrained(
        path)
    return path


@pytest.fixture(scope="module")
def deeplab_pb(tmp_path_factory):
    """A one-op frozen graph with DeepLab's signature: the class of a
    pixel is its brightest channel."""
    import tensorflow as tf

    graph = tf.Graph()
    with graph.as_default():
        image = tf.compat.v1.placeholder(tf.uint8, [1, None, None, 3],
                                         name="ImageTensor")
        tf.argmax(image, axis=3, name="SemanticPredictions")
    path = str(tmp_path_factory.mktemp("deeplab") / "frozen.pb")
    with open(path, "wb") as f:
        f.write(graph.as_graph_def().SerializeToString())
    return path


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    img_files = _write_frames(root, videos=2, frames=4, h=48, w=80)
    imglst = os.path.join(root, "imgs.lst")
    with open(imglst, "w") as f:
        f.write("\n".join(img_files) + "\n")
    return imglst


FLAGS = {
    "default": [],
    "keep_full": ["--keep_full"],
    "two_level_every": ["--save_two_level", "--every", "2",
                        "--down_rate", "4"],
    "job": ["--job", "3", "--curJob", "2", "--down_rate", "2"],
}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("backend", ["segformer", "deeplab"])
def test_command_writes_the_jax_commands_npys(backend, flags, frames,
                                              request, tmp_path):
    model = request.getfixturevalue(
        "segformer_dir" if backend == "segformer" else "deeplab_pb")
    argv = FLAGS[flags]
    got = _run(port_cli.extract_scene_seg_main,
               [frames, model, str(tmp_path / "port"), *argv,
                "--device", "cpu"])
    want = _run(jax_cli.extract_scene_seg_main,
                [frames, model, str(tmp_path / "jax"), *argv])
    assert got == want and got.startswith("wrote ")
    _same_npys(str(tmp_path / "port"), str(tmp_path / "jax"))
    one = os.path.join(str(tmp_path / "port"), files(str(tmp_path / "port"))[0])
    seg = np.load(one)
    assert seg.dtype == np.uint8
    if backend == "segformer":
        assert seg.min() >= 1 and seg.max() <= 6   # ADE ids are 1-based
    else:
        assert seg.max() <= 2


@pytest.mark.parametrize("package,model", [
    ("cv2", "model.pb"), ("cv2", "segformer"), ("tensorflow", "model.pb"),
    ("transformers", "segformer")])
def test_command_without_its_package_raises(package, model, tmp_path,
                                            monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)
    argv = [str(tmp_path / "imgs.lst"), str(tmp_path / model),
            str(tmp_path / "out")]
    with pytest.raises(ImportError) as err:
        port_cli.extract_scene_seg_main(argv)
    assert err.value.name == package
    assert "mvt-torch-extract-scene-seg" in str(err.value)
    assert os.listdir(tmp_path) == []
