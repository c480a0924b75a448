"""The port's TF1 checkpoint reader and converter, held against
TensorFlow and the JAX package: ``tf_bundle.BundleReader`` equals
``tf.train.load_checkpoint`` for every variable of bundles that
``tf.compat.v1.train.Saver`` writes with the reference's names, their
Adadelta slots and global_step (one shard, ``sharded=True``, and a table
of several blocks); the port's ``convert_tf_checkpoint`` and
``mvt-torch-convert-tf`` equal the JAX package's ``convert_tf_checkpoint``
and ``mvt-convert-tf`` leaf for leaf, strict and ``--non_strict``; the
name mapping (``tests/test_tf_converter.py``'s four tests, on the port's
module); and malformed bundles raise ``ValueError`` naming the file.
The committed bundle (``tests/torch_fixtures/tf_ckpt``,
``tests/make_tf_fixture.py``) reads equal to the leaves made from its
seed with no tensorflow. Every comparison is at tolerance 0."""

import os
import shutil
import struct

import jax
import numpy as np
import pytest

from chip_smoke import TF_FIXTURE, TF_FIXTURE_FLAGS, fixture_tree
from make_tf_fixture import (
    REFERENCE_NAMES,
    STEP,
    fixture_config,
    fixture_tensors,
    write_bundle,
)
from multiverse_tpu.cli import convert_tf as jax_convert_cli
from multiverse_tpu.config import MultiverseConfig as JaxConfig
from multiverse_tpu.models import init_params
from multiverse_tpu.tools import tf_converter as jax_tf_converter
from multiverse_torch.bridge import params_to_numpy_tree
from multiverse_torch.cli import convert_tf
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.models import Multiverse
from multiverse_torch.tools import tf_bundle
from multiverse_torch.tools.tf_bundle import BundleReader, mask_crc
from multiverse_torch.tools.tf_converter import (
    _set_path,
    convert_tf_checkpoint,
    map_reference_variables,
    map_variable,
)
from multiverse_torch.train.checkpoints import read_checkpoint_tree
from multiverse_torch.train.ocdbt import crc32c


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_trees_equal(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


def _assert_reads_as_tf(tf, path):
    ours = BundleReader(path)
    theirs = tf.train.load_checkpoint(path)
    shapes = theirs.get_variable_to_shape_map()
    assert ours.get_variable_to_shape_map() == shapes
    for name in shapes:
        want = theirs.get_tensor(name)
        got = ours.get_tensor(name)
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return ours


# ------------------------------------------------------ the committed bundle


def test_the_committed_bundle_reads_equal_to_its_seed():
    """No tensorflow needed: every weight equals ``fixture_leaf`` of its
    port name, and global_step is the fixture's step."""
    reader = BundleReader(TF_FIXTURE)
    assert reader.prefix == os.path.join(TF_FIXTURE, "model-%d" % STEP)
    want = _flat(fixture_tree(Multiverse.init(fixture_config())))
    for name, port in REFERENCE_NAMES.items():
        got = reader.get_tensor(name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want[port], err_msg=name)
    assert reader.get_tensor("global_step") == STEP
    assert reader.get_tensor("global_step").dtype == np.int64
    slots = [n for n in reader.get_variable_to_shape_map() if "Adadelta" in n]
    assert slots and all(reader.get_tensor(n).shape
                         == reader.get_tensor(n.rsplit("/", 1)[0]).shape
                         for n in slots)
    size = sum(os.path.getsize(os.path.join(TF_FIXTURE, f))
               for f in os.listdir(TF_FIXTURE))
    assert size < 1 << 20


def test_the_committed_bundle_reads_as_tf_reads_it(tf):
    _assert_reads_as_tf(tf, TF_FIXTURE)


# ------------------------------------------------------------- vs TF


def _reference_tensors(seed: int, scales=(0, 1)) -> dict:
    """The reference's variable names at both grid scales with an
    Adadelta slot pair each and global_step, small random values."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in REFERENCE_NAMES:
        for i in scales:
            if "scene_conv" in name and i:
                continue
            n = name.replace("_0/", "_%d/" % i)
            shape = tuple(rng.randint(1, 4, rng.randint(0, 4)))
            for suffix in ("", "/Adadelta", "/Adadelta_1"):
                out[n + suffix] = rng.standard_normal(shape).astype(
                    np.float32)
    out["global_step"] = np.int64(seed)
    return out


@pytest.mark.parametrize("sharded", [False, True])
def test_bundle_reader_equals_tensorflow(tf, sharded, tmp_path):
    """A Saver's bundle of the reference's names (both scales), their
    slots and global_step, in one data file or sharded over two."""
    prefix = write_bundle(str(tmp_path), _reference_tensors(3), 40,
                          sharded=sharded)
    reader = _assert_reads_as_tf(tf, str(tmp_path))
    assert reader.prefix == prefix
    assert reader.num_shards == (2 if sharded else 1)
    assert sorted(os.listdir(str(tmp_path))) == sorted(
        ["checkpoint", "model-40.index"]
        + ["model-40.data-%05d-of-%05d" % (i, reader.num_shards)
           for i in range(reader.num_shards)])
    assert _assert_reads_as_tf(tf, prefix).prefix == prefix


def _data_blocks(index_path: str) -> int:
    with open(index_path, "rb") as f:
        data = f.read()
    footer = data[-tf_bundle.FOOTER_BYTES:]
    _, pos = tf_bundle._varint(footer, 0, index_path)
    _, pos = tf_bundle._varint(footer, pos, index_path)
    index = tf_bundle._handle(footer[pos:], index_path)
    return len(tf_bundle._block_entries(
        tf_bundle._block(data, index, index_path), index_path))


def test_a_table_of_several_blocks(tf, tmp_path):
    """2,500 tensors of long distinct names: the index spans more than
    one 256 KiB data block and many restart points, in int32, int64,
    float64 and float32."""
    rng = np.random.RandomState(1)
    dtypes = [np.float32, np.float64, np.int32, np.int64]
    names = ["%04d/%s" % (i, "w" * 120) for i in range(2500)]
    values = [(rng.standard_normal(3) * 100).astype(dtypes[i % 4])
              for i in range(len(names))]
    prefix = str(tmp_path / "model")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names), tensors=values)
    assert _data_blocks(prefix + ".index") > 1
    _assert_reads_as_tf(tf, prefix)


# --------------------------------------------------- converter vs JAX


def _jax_template(cfg):
    return init_params(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("strict", [True, False])
def test_convert_tf_checkpoint_equals_jax(tf, strict, tmp_path):
    """The committed bundle (strict), and a bundle of both scales into a
    use_grids 1,0 model (non-strict: the scale-1 variables skipped), the
    port's and the JAX package's functions leaf for leaf."""
    if strict:
        path = TF_FIXTURE
    else:
        tensors = fixture_tensors()
        for name, value in list(tensors.items()):
            if "_0/" in name:
                tensors[name.replace("_0/", "_1/")] = value
        path = str(tmp_path)
        write_bundle(path, tensors, 7)
    cfg = fixture_config()
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "emb_size", "enc_hidden_size", "dec_hidden_size", "scene_conv_dim",
        "use_grids", "use_scene_enc", "use_gnn")}).validate()
    ours = convert_tf_checkpoint(path, cfg,
                                 params_to_numpy_tree(Multiverse.init(cfg)),
                                 strict=strict)
    theirs = jax_tf_converter.convert_tf_checkpoint(
        path, jcfg, _jax_template(jcfg), strict=strict)
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, theirs))
    _assert_trees_equal(ours, fixture_tree(Multiverse.init(cfg)))
    if not strict:
        with pytest.raises(KeyError):
            convert_tf_checkpoint(
                path, cfg, params_to_numpy_tree(Multiverse.init(cfg)))


def test_strict_errors_equal_jax(tf, tmp_path):
    """A bundle without one weight: both functions refuse it strictly
    with the same message, and neither fills it otherwise."""
    tensors = fixture_tensors()
    del tensors["person_pred/scene_conv2/b"]
    write_bundle(str(tmp_path), tensors, 7)
    cfg = fixture_config()
    jcfg = JaxConfig(emb_size=16, enc_hidden_size=32, dec_hidden_size=32,
                     scene_conv_dim=16, use_scene_enc=True,
                     use_gnn=True).validate()
    with pytest.raises(ValueError) as ours:
        convert_tf_checkpoint(str(tmp_path), cfg,
                              params_to_numpy_tree(Multiverse.init(cfg)))
    with pytest.raises(ValueError) as theirs:
        jax_tf_converter.convert_tf_checkpoint(
            str(tmp_path), jcfg, _jax_template(jcfg))
    assert "scene_conv2', 'b'" in str(ours.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("strict", [True, False])
def test_convert_cli_equals_mvt_convert_tf(tf, strict, tmp_path, capsys):
    """``mvt-torch-convert-tf`` and ``mvt-convert-tf`` on the committed
    bundle: save and best step 0 of both run directories read equal, and
    the printed line is the same but for the output path."""
    flags = TF_FIXTURE_FLAGS + ([] if strict else ["--non_strict"])
    convert_tf.main([TF_FIXTURE, str(tmp_path / "port"), "m", "3",
                     *flags])
    ours = capsys.readouterr().out.strip()
    jax_convert_cli.main([TF_FIXTURE, str(tmp_path / "jax"), "m", "3",
                          *flags])
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs.replace(str(tmp_path / "jax"),
                                  str(tmp_path / "port"))
    for sub in ("save", "best"):
        got = read_checkpoint_tree(str(tmp_path / "port" / "m" / "03" / sub
                                       / "0"))
        want = read_checkpoint_tree(str(tmp_path / "jax" / "m" / "03" / sub
                                        / "0"))
        _assert_trees_equal(got, want)


# ------------------------------------------------- the name mapping

CFG = MultiverseConfig(scene_grid_strides=(2, 4),
                       use_grids=(True, False)).validate()
# tests/test_tf_converter.py's reference names
NAMES = list(REFERENCE_NAMES)[4:] + list(REFERENCE_NAMES)[:4] + [
    "global_step", "person_pred/scene_conv1/W/Adadelta",
    "person_pred/scene_conv1/W/Adadelta_1"]


def test_map_covers_all_model_variables():
    mapping = map_reference_variables(NAMES, CFG)
    assert "global_step" not in mapping
    assert not any("Adadelta" in k for k in mapping)
    assert len(mapping) == 18
    params = params_to_numpy_tree(Multiverse.init(
        CFG.replace(use_scene_enc=True)))
    for name, path in mapping.items():
        node = params
        for key in path:
            assert key in node, (name, path)
            node = node[key]
    covered = set(mapping.values())
    assert {tuple(k.split("/")) for k in _flat(params)} == covered
    assert mapping == jax_tf_converter.map_reference_variables(
        NAMES, JaxConfig(scene_grid_strides=(2, 4),
                         use_grids=(True, False)).validate())


def test_map_disambiguates_cells():
    assert map_variable(
        "a/enc_grid_regress_0/kernel", CFG) == (
        "scales", "0", "enc_reg", "kernel")
    assert map_variable("a/enc_grid_0/kernel", CFG) == (
        "scales", "0", "enc_class", "kernel")
    assert map_variable("a/dec_grid_reg_0/biases", CFG) == (
        "scales", "0", "dec_reg", "bias")
    assert map_variable("person_pred/grid_emb/W", CFG) == (
        "scales", "0", "enc_grid_emb", "w")
    assert map_variable(
        "person_pred/decoder_grid_class_0/grid_emb/W", CFG) == (
        "scales", "0", "dec_class_emb", "w")
    assert map_variable(
        "person_pred/decoder_grid_class_0/decoder_rnn/grid_emb/W",
        CFG) == ("scales", "0", "dec_class_emb", "w")
    assert map_variable(
        "person_pred/decoder_grid_reg_0/decoder_rnn/grid_emb/b",
        CFG) == ("scales", "0", "dec_reg_emb", "b")
    assert map_variable("whatever/unrelated/W", CFG) is None


def test_set_path_shape_check():
    params = params_to_numpy_tree(Multiverse.init(
        CFG.replace(use_scene_enc=True)))
    good = np.zeros_like(params["scene_conv1"]["b"])
    _set_path(params, ("scene_conv1", "b"), good)
    with pytest.raises(ValueError):
        _set_path(params, ("scene_conv1", "b"),
                  np.zeros((3,), np.float32))
    with pytest.raises(KeyError):
        _set_path(params, ("scene_conv1", "nope"), good)


def test_duplicate_mapping_rejected():
    with pytest.raises(ValueError):
        map_reference_variables(
            ["a/scene_conv1/W", "b/scene_conv1/W"], CFG)


# ------------------------------------------------------- malformed input


def _index_block(data: bytes, path: str):
    """(offset, size) of the index block and of its one data block."""
    footer = data[-tf_bundle.FOOTER_BYTES:]
    _, pos = tf_bundle._varint(footer, 0, path)
    _, pos = tf_bundle._varint(footer, pos, path)
    index = tf_bundle._handle(footer[pos:], path)
    (_, handle), = tf_bundle._block_entries(
        tf_bundle._block(data, index, path), path)
    return index, tf_bundle._handle(handle, path)


def _reseal(data: bytearray, offset: int, size: int, kind: int = 0):
    """Give the block at ``offset`` the compression type ``kind`` and a
    trailer crc that matches its (edited) contents."""
    data[offset + size] = kind
    data[offset + size + 1:offset + size + 5] = struct.pack(
        "<I", mask_crc(crc32c(bytes(data[offset:offset + size + 1]))))


def _edit_index(path, edit):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    edit(data, *_index_block(bytes(data), path))
    with open(path, "wb") as f:
        f.write(data)


def _flip_block(data, index, block):
    data[block[0] + 10] ^= 0x40


def _bad_entry(data, index, block):
    # the first entry after the header names DT_STRING, crc resealed
    at = data.index(b"person_pred/decoder", block[0])
    dtype = data.index(b"\x08\x01", at)
    data[dtype + 1] = 7
    _reseal(data, *block)


def _snappy(data, index, block):
    _reseal(data, block[0], block[1], kind=1)


def _bad_magic(data, index, block):
    data[-1] ^= 0x01


MALFORMED = {
    "block_crc": ("index", _flip_block, "crc32c mismatch in the block"),
    "entry": ("index", _bad_entry, "decoder_grid_class_0.*dtype 7"),
    "snappy": ("index", _snappy, "compressed \\(type 1\\)"),
    "magic": ("index", _bad_magic, "bad magic"),
    "truncated_index": ("index", None, "bad magic|truncated"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_a_malformed_index_raises_naming_it(case, tmp_path):
    shutil.copytree(TF_FIXTURE, str(tmp_path / "ckpt"))
    path = str(tmp_path / "ckpt" / ("model-%d.index" % STEP))
    _, edit, message = MALFORMED[case]
    if edit is None:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 20)
    else:
        _edit_index(path, edit)
    with pytest.raises(ValueError, match=message) as e:
        BundleReader(str(tmp_path / "ckpt"))
    assert path in str(e.value)


@pytest.mark.parametrize("case", ["flipped", "truncated"])
def test_a_damaged_tensor_raises_naming_its_file(case, tmp_path):
    """A flipped byte fails its entry's crc; a data file cut short
    fails before the crc: each names the data file and the tensor."""
    shutil.copytree(TF_FIXTURE, str(tmp_path / "ckpt"))
    reader = BundleReader(str(tmp_path / "ckpt"))
    name = "person_pred/decoder_grid_class_0/decoder_rnn/dec_grid_0/kernel"
    entry = reader._entries[name]
    path = reader.data_path(0)
    with open(path, "r+b") as f:
        if case == "flipped":
            f.seek(entry.offset + entry.size // 2)
            b = f.read(1)
            f.seek(entry.offset + entry.size // 2)
            f.write(bytes([b[0] ^ 0x10]))
        else:
            f.truncate(entry.offset + entry.size - 1)
    with pytest.raises(ValueError, match="crc32c mismatch" if case ==
                       "flipped" else "truncated") as e:
        reader.get_tensor(name)
    assert path in str(e.value) and name in str(e.value)


def test_a_sliced_variable_is_refused(tf, tmp_path):
    """A partitioned variable's bundle (its slices under binary keys, the
    whole entry carrying slices) is refused naming the index."""
    graph = tf.Graph()
    with graph.as_default():
        tf.compat.v1.get_variable(
            "person_pred/scene_conv1/W", shape=[4, 3],
            partitioner=tf.compat.v1.fixed_size_partitioner(2),
            initializer=tf.compat.v1.ones_initializer())
        saver = tf.compat.v1.train.Saver(save_relative_paths=True)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "model"),
                                write_meta_graph=False)
    with pytest.raises(ValueError, match="partitioned") as e:
        BundleReader(prefix)
    assert prefix + ".index" in str(e.value)
    assert "scene_conv1/W" in str(e.value)


def test_a_big_endian_header_is_refused(tmp_path):
    """The header's endianness field set to BIG (its block resealed)."""
    shutil.copytree(TF_FIXTURE, str(tmp_path / "ckpt"))
    path = str(tmp_path / "ckpt" / ("model-%d.index" % STEP))

    def big_endian(data, index, block):
        # the header is the block's first entry: key "", then its value
        # (num_shards = 1, then the version); insert nothing, flip the
        # num_shards field's tag into the endianness field's
        at = block[0] + 3
        assert data[at:at + 2] == b"\x08\x01"
        data[at] = 0x10
        _reseal(data, *block)

    _edit_index(path, big_endian)
    with pytest.raises(ValueError, match="big-endian") as e:
        BundleReader(str(tmp_path / "ckpt"))
    assert path in str(e.value)


def test_protobuf_decoder_fields_and_faults():
    msg = (b"\x08\x96\x01" + b"\x15" + struct.pack("<I", 7)
           + b"\x19" + struct.pack("<Q", 9) + b"\x22\x02ab" + b"\x08\x02")
    assert tf_bundle.parse_message(msg, "m") == {
        1: [150, 2], 2: [7], 3: [9], 4: [b"ab"]}
    for bad, what in ((b"\x22\x05ab", "truncated field 4"),
                      (b"\x0b", "wire type 3"), (b"\x08", "truncated"),
                      (b"\x00\x01", "field number 0")):
        with pytest.raises(ValueError, match=what):
            tf_bundle.parse_message(bad, "m")
