"""The port's writer of the JAX package's orbax layout, held against
the port's reader, tensorstore and the JAX package: ``write_database``
and ``write_params_step`` round-trip through ``OcdbtReader`` and
``read_params_tree`` (nested trees, 0-d and empty leaves, B-trees split
into many nodes); tensorstore's ``ocdbt`` driver reads every key and
array written; JAX's ``restore_params_from``,
``CheckpointManager.restore_params`` and ``poll_latest_step`` read a
port-written step and never a step still under its temporary name; the
key set, ``.zarray``s and tree metadata equal what JAX's
``CheckpointManager.save`` writes; other dtypes are refused; and JAX's
``mvt-test`` on a run ``mvt-torch-train`` wrote prints what it prints on
the same weights saved by the JAX package. Every comparison is at
tolerance 0."""

import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multiverse_tpu.cli import test as jax_test_cli
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager,
    restore_params_from,
)
from multiverse_torch.bridge import params_from_jax, params_to_numpy_tree
from multiverse_torch.cli import train as ttrain
from multiverse_torch.data.dataset import synthesize_prepro
from multiverse_torch.models import Multiverse
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    list_steps,
    read_checkpoint_tree,
)
from multiverse_torch.train.ocdbt import OcdbtReader, write_database
from multiverse_torch.train.orbax_reader import read_params_tree
from multiverse_torch.train.orbax_writer import (
    TMP_SUFFIX,
    write_params_step,
    written_by_port,
)
from synthetic import tiny_config

TINY_FLAGS = ["--obs_len", "4", "--pred_len", "5", "--scene_h", "12",
              "--scene_w", "16", "--scene_class", "5", "--emb_size", "8",
              "--enc_hidden_size", "16", "--dec_hidden_size", "16",
              "--scene_conv_dim", "8", "--scene_grid_strides", "2,4",
              "--use_gnn", "--use_scene_enc"]


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


def _tiny_tree(use_grids=(True, True), seed=0) -> dict:
    cfg = tiny_config(use_grids=use_grids, use_gnn=True, use_scene_enc=True)
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(seed), cfg))


def _ts():
    return pytest.importorskip("tensorstore")


# ------------------------------------------------------------ round trip


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run directory whose save and best hold step 40 written by the
    port's ``CheckpointManager``, and the params written."""
    run = str(tmp_path_factory.mktemp("port") / "toy" / "00")
    tree = _tiny_tree(seed=1)
    mgr = CheckpointManager(run)
    model = params_from_jax(tree)
    mgr.save(40, model)
    mgr.save(40, model, best=True)
    return run, tree


def test_save_writes_an_orbax_step_that_reads_back(port_run):
    run, tree = port_run
    for sub in ("save", "best"):
        steps = list_steps(os.path.join(run, sub))
        assert [s for s, _ in steps] == [40]
        assert steps[0][1] == os.path.join(run, sub, "40")
        assert written_by_port(steps[0][1])
        assert sorted(os.listdir(steps[0][1])) == \
            ["_CHECKPOINT_METADATA", "default"]
        _assert_trees_equal(read_checkpoint_tree(steps[0][1]), tree)


def _trees():
    names = st.text(alphabet="abcdefgh_0123456789", min_size=1,
                    max_size=6)
    shapes = st.lists(st.integers(0, 4), min_size=0, max_size=4)

    def leaf(shape):
        return st.integers(0, 2 ** 31 - 1).map(
            lambda seed: np.random.RandomState(seed)
            .standard_normal(shape).astype(np.float32))

    leaves = shapes.flatmap(leaf)
    return st.recursive(
        st.dictionaries(names, leaves, min_size=1, max_size=4),
        lambda inner: st.dictionaries(names, inner | leaves, min_size=1,
                                      max_size=4),
        max_leaves=12)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_trees())
def test_any_tree_round_trips(tree, tmp_path_factory):
    """Nested trees of any shapes, 0-d and empty leaves included: what
    the port writes, its reader returns."""
    save = str(tmp_path_factory.mktemp("any"))
    step = write_params_step(save, 7, tree)
    got = read_params_tree(step)
    want = _flat(tree)
    got = _flat(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(entries=st.dictionaries(st.binary(max_size=12),
                               st.binary(max_size=300), min_size=1,
                               max_size=60),
       inline=st.integers(0, 64),
       node=st.sampled_from([400, 2000, 100_000_000]))
def test_write_database_round_trips(entries, inline, node, tmp_path_factory):
    """Any keys and values, inline or in the data file, B-trees of one
    node or of many levels: the reader returns them, and tensorstore's
    ocdbt driver lists and reads the same."""
    ts = _ts()
    root = str(tmp_path_factory.mktemp("db"))
    write_database(root, entries, max_inline_value_bytes=inline,
                   max_decoded_node_bytes=node)
    reader = OcdbtReader(root)
    assert reader.keys() == sorted(entries)
    for k, v in entries.items():
        assert reader.read(k) == v
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + root + "/"}).result()
    assert sorted(kv.list().result()) == sorted(entries)
    for k, v in entries.items():
        assert kv.read(k).result().value == v


def test_nodes_split_within_the_limit(tmp_path):
    """A store of 300 keys under a 1000-byte node limit: tensorstore
    walks a tree with interior levels, every node it visits holds at
    most that many bytes, and the statistics of each subtree add up."""
    ts = _ts()
    rng = np.random.RandomState(0)
    entries = {b"params.w%03d/0" % i: rng.bytes(40) for i in range(300)}
    write_database(str(tmp_path), entries, max_inline_value_bytes=16,
                   max_decoded_node_bytes=1000)
    base = ts.KvStore.open("file://" + str(tmp_path) + "/").result()
    (version,) = ts.ocdbt.dump(base).result()["versions"]
    assert version["root_height"] >= 2
    root = version["root"]
    assert root["statistics"] == {"num_keys": 300,
                                  "num_indirect_value_bytes": 300 * 40,
                                  "num_tree_bytes": root["statistics"][
                                      "num_tree_bytes"]}
    seen = []

    def walk(ref):
        length = int(ref["location"].rsplit(":", 1)[1])
        assert length <= 1000
        seen.append(length)
        node = ts.ocdbt.dump(base, ref["location"]).result()
        children = [e for e in node["entries"]
                    if str(e.get("location", "")).startswith("btreenode")]
        if not children:
            return
        for key in ("num_keys", "num_indirect_value_bytes"):
            assert sum(c["statistics"][key] for c in children) == \
                ref["statistics"][key]
        assert sum(c["statistics"]["num_tree_bytes"] for c in children) \
            + length == ref["statistics"]["num_tree_bytes"]
        for c in children:
            walk(c)

    walk(root)
    assert len(seen) > 3
    assert sum(seen) == root["statistics"]["num_tree_bytes"]
    assert OcdbtReader(str(tmp_path)).keys() == sorted(entries)


# ------------------------------------------------------------ tensorstore


def test_tensorstore_opens_every_written_array(port_run):
    ts = _ts()
    run, tree = port_run
    root = os.path.join(run, "save", "40", "default")
    for name, want in _flat({"params": tree}).items():
        arr = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": "file://" + root + "/",
            "path": name.replace("/", ".") + "/"}}).result()
        got = np.asarray(arr.read().result())
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


# -------------------------------------------------------------------- JAX


def test_jax_restores_a_port_step(port_run):
    """``restore_params_from`` (the step's directory and the save
    directory), ``CheckpointManager.restore_params`` of save and best,
    and a (1,0) template pruned from the (1,1) step."""
    run, tree = port_run
    cfg = tiny_config(use_grids=(True, True), use_gnn=True,
                      use_scene_enc=True)
    template = jax_init_params(jax.random.PRNGKey(0), cfg)
    mgr = JaxCheckpointManager(run)
    for got in (restore_params_from(os.path.join(run, "save"), template),
                mgr.restore_params(template),
                mgr.restore_params(template, best=True)):
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, got), tree)
    assert mgr.latest_step() == mgr.latest_step(best=True) == 40
    small = jax_init_params(jax.random.PRNGKey(0), tiny_config(
        use_grids=(True, False), use_gnn=True, use_scene_enc=True))
    pruned = jax.tree_util.tree_map(
        np.asarray, restore_params_from(os.path.join(run, "save"), small))
    want = dict(tree, scales={"0": tree["scales"]["0"]})
    _assert_trees_equal(pruned, want)


def test_a_step_in_flight_is_invisible(port_run, tmp_path):
    """A step still under its temporary name: neither the port's
    ``list_steps`` nor JAX's ``poll_latest_step``, ``restore_params`` or
    ``restore_params_from`` sees it."""
    run, tree = port_run
    shutil.copytree(run, str(tmp_path / "run"))
    save = tmp_path / "run" / "save"
    shutil.copytree(str(save / "40"),
                    str(save / ("80" + TMP_SUFFIX + "123")))
    assert [s for s, _ in list_steps(str(save))] == [40]
    mgr = JaxCheckpointManager(str(tmp_path / "run"))
    assert mgr.poll_latest_step() == 40
    cfg = tiny_config(use_grids=(True, True), use_gnn=True,
                      use_scene_enc=True)
    template = jax_init_params(jax.random.PRNGKey(0), cfg)
    _assert_trees_equal(jax.tree_util.tree_map(
        np.asarray, mgr.restore_params(template)), tree)
    _assert_trees_equal(jax.tree_util.tree_map(
        np.asarray, restore_params_from(str(save), template)), tree)
    # the rename that ends the write: now every reader follows it
    os.rename(str(save / ("80" + TMP_SUFFIX + "123")), str(save / "80"))
    assert [s for s, _ in list_steps(str(save))] == [40, 80]
    assert mgr.poll_latest_step() == 80


def test_the_layout_equals_what_jax_writes(port_run, tmp_path):
    """The same params saved by JAX's ``CheckpointManager``: the OCDBT
    key set, every ``.zarray`` but its compressor, ``_METADATA``'s tree
    metadata and ``array_metadatas`` equal the port's; the port's
    ``_CHECKPOINT_METADATA`` names the same handler."""
    run, tree = port_run
    JaxCheckpointManager(str(tmp_path)).save(
        40, jax.tree_util.tree_map(jax.numpy.asarray, tree))
    theirs = str(tmp_path / "save" / "40")
    ours = os.path.join(run, "save", "40")
    db_t = OcdbtReader(os.path.join(theirs, "default"))
    db_o = OcdbtReader(os.path.join(ours, "default"))
    assert db_o.keys() == db_t.keys()
    for key in db_t.keys():
        if key.endswith(b"/.zarray"):
            zt, zo = json.loads(db_t.read(key)), json.loads(db_o.read(key))
            assert zt.pop("compressor")["id"] == "zstd"
            assert zo.pop("compressor") is None
            assert zo == zt, key

    def meta(step, *path):
        with open(os.path.join(step, *path)) as f:
            return json.load(f)

    for path, field in ((("default", "_METADATA"), "tree_metadata"),
                        (("default", "array_metadatas", "process_0"),
                         "array_metadatas")):
        assert meta(ours, *path)[field] == meta(theirs, *path)[field]
    m_o, m_t = (meta(s, "default", "_METADATA") for s in (ours, theirs))
    assert {k: v for k, v in m_o.items() if k != "tree_metadata"} == \
        {k: v for k, v in m_t.items() if k != "tree_metadata"}
    c_o, c_t = (meta(s, "_CHECKPOINT_METADATA") for s in (ours, theirs))
    assert c_o["item_handlers"] == c_t["item_handlers"]
    assert set(c_o) == set(c_t)
    assert c_o["custom_metadata"] == {"written_by": "multiverse_torch"}
    assert c_t["custom_metadata"] == {}
    assert not written_by_port(theirs)


# ---------------------------------------------------------- refusals


@pytest.mark.parametrize("leaf", [np.zeros(3, np.float64),
                                  np.zeros(3, np.int32),
                                  np.zeros(3, ">f4"), [1.0, 2.0]])
def test_other_dtypes_are_refused_not_cast(leaf, tmp_path):
    with pytest.raises(ValueError, match="params.a.w: .* is not a float32"):
        write_params_step(str(tmp_path), 1, {"a": {"w": leaf}})
    assert os.listdir(str(tmp_path)) == []


def test_save_refuses_a_jax_step_and_replaces_its_own(port_run, tmp_path):
    """A step number the JAX package holds is refused, whole; a step the
    port wrote is replaced; max_to_keep removes only the port's steps."""
    run, tree = port_run
    JaxCheckpointManager(str(tmp_path)).save(
        10, jax.tree_util.tree_map(jax.numpy.asarray, tree))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    other = params_from_jax(_tiny_tree(seed=2))
    with pytest.raises(ValueError, match="port did not write"):
        mgr.save(10, other)
    _assert_trees_equal(read_checkpoint_tree(mgr.save_dir + "/10"), tree)
    mgr.save(20, params_from_jax(tree))
    mgr.save(20, other)
    _assert_trees_equal(read_checkpoint_tree(mgr.save_dir + "/20"),
                        params_to_numpy_tree(other))
    for step in (30, 40):
        mgr.save(step, other)
    assert [s for s, _ in list_steps(mgr.save_dir)] == [10, 30, 40]
    assert sorted(os.listdir(mgr.save_dir)) == ["10", "30", "40"]


# --------------------------------------------------- JAX's mvt-test


def _jax_test_table(prepro, outbase, model) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_test_cli.main([prepro, outbase, model, "--batch_size", "4",
                           *TINY_FLAGS])
    text = out.getvalue()
    return text[text.index("performance:"):]


def test_jax_mvt_test_on_a_port_run(tmp_path):
    """``mvt-torch-train --device cpu`` writes a run; JAX's ``mvt-test``
    on that run directory prints the table it prints on the same weights
    saved by the JAX package's own ``CheckpointManager``."""
    cfg = tiny_config(use_gnn=True, use_scene_enc=True)
    prepro = synthesize_prepro(str(tmp_path / "prepro"), cfg, n_train=8,
                               n_val=8, seed=3)
    shutil.copy(os.path.join(prepro, "data_val.npz"),
                os.path.join(prepro, "data_test.npz"))
    outbase = str(tmp_path / "out")
    ttrain.main([prepro, outbase, "port", "--batch_size", "4",
                 "--num_epochs", "1", "--save_period", "2", "--init_lr",
                 "0.3", "--device", "cpu", *TINY_FLAGS])
    step, path = list_steps(os.path.join(outbase, "port", "00",
                                         "save"))[-1]
    tree = read_checkpoint_tree(path)
    JaxCheckpointManager(os.path.join(outbase, "jax", "00")).save(
        step, jax.tree_util.tree_map(jax.numpy.asarray, tree))
    ours = _jax_test_table(prepro, outbase, "port")
    theirs = _jax_test_table(prepro, outbase, "jax")
    assert "grid0_traj_ade" in ours
    assert ours == theirs
