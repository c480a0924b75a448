"""The port's reader of the JAX package's orbax checkpoints, held
against the JAX package and tensorstore: ``OcdbtReader`` equals
tensorstore's OCDBT key-value store key for key (an orbax step, and a
store with interior B-tree nodes, indirect values and version-tree
nodes); corrupt files raise; the zarr reader equals
tensorstore's zarr driver; ``read_params_tree`` of a JAX
``CheckpointManager`` save equals the JAX params exactly (at the tiny
and the published widths), and ``load_checkpoint`` prunes it as
``restore_params_from`` does; ``list_steps`` over npz and orbax steps;
and the committed fixture reads equal to the leaves made from its
seed."""

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from multiverse_tpu.config import MultiverseConfig as JaxConfig
from multiverse_tpu.models import init_params as jax_init_params
from multiverse_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager,
    restore_params_from,
)
from multiverse_torch.bridge import params_from_jax, save_params_npz
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.models import Multiverse
from multiverse_torch.native import zstd
from multiverse_torch.train import ocdbt, orbax_reader
from multiverse_torch.train.checkpoints import (
    CheckpointManager,
    list_steps,
    load_checkpoint,
    read_checkpoint_tree,
    resolve_checkpoint,
)
from multiverse_torch.train.ocdbt import OcdbtReader
from multiverse_torch.train.orbax_reader import (
    is_orbax_step,
    orbax_steps,
    read_params_tree,
)
from chip_smoke import FIXTURE_GRIDS, fixture_tree
from synthetic import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "jax_run")


def _numpy(tree) -> dict:
    return jax.tree_util.tree_map(np.asarray, tree)


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
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32),
                                      err_msg=k)


def _port_cfg() -> MultiverseConfig:
    """The port's configuration at tests/synthetic.py's tiny dims."""
    return MultiverseConfig(
        obs_len=4, pred_len=5, scene_h=12, scene_w=16, scene_class=5,
        emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
        scene_conv_dim=8, scene_grid_strides=(2, 4),
        use_grids=(True, False), use_gnn=True, use_scene_enc=True,
        batch_size=4).validate()


def _tiny_params(use_grids, seed):
    cfg = tiny_config(use_grids=use_grids, use_gnn=True, use_scene_enc=True)
    return jax_init_params(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory written by the JAX package's CheckpointManager:
    steps 100 and 200 of the tiny (1,1) model in ``save``, step 150 in
    ``best``."""
    run = str(tmp_path_factory.mktemp("jax_run") / "m" / "00")
    mgr = JaxCheckpointManager(run)
    params = {s: _tiny_params((True, True), s) for s in (1, 2, 3)}
    mgr.save(100, params[1])
    mgr.save(200, params[2])
    mgr.save(150, params[3], best=True)
    return run, {100: params[1], 200: params[2], 150: params[3]}


def _ts_kvstore(root: str):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + root + "/"}).result()


def _assert_store_equal(reader: OcdbtReader, kv):
    want = kv.list().result()
    assert reader.keys() == sorted(want)
    for k in want:
        assert reader.read(k) == kv.read(k).result().value, k


def test_ocdbt_reader_equals_tensorstore_on_an_orbax_step(jax_run):
    """The keys and values of a JAX step's database, inline and indirect
    (values in ``ocdbt.process_0/``), as tensorstore lists and reads
    them."""
    run, _ = jax_run
    root = os.path.join(run, "save", "200", "default")
    reader = OcdbtReader(root)
    _assert_store_equal(reader, _ts_kvstore(root))
    assert b"params.scales.0.dec_class.kernel/.zarray" in reader.keys()
    with pytest.raises(KeyError):
        reader.read("params.no_such/.zarray")


@pytest.fixture(scope="module")
def many_versions(tmp_path_factory):
    """A tensorstore OCDBT store with 256-byte nodes and no inline
    values, committed to 40 times: interior B-tree nodes, every value
    indirect, and version-tree nodes."""
    root = str(tmp_path_factory.mktemp("ocdbt_versions"))
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": "file://" + root + "/",
        "config": {"max_decoded_node_bytes": 256,
                   "max_inline_value_bytes": 0}}).result()
    for i in range(40):
        kv.write(b"key%03d/some/long/path" % i, b"v%d" % i * (i + 1)).result()
    return root


def test_ocdbt_reader_equals_tensorstore_past_version_tree_nodes(
        many_versions):
    """The latest version of a store whose manifest also references
    version-tree nodes (parsed past, never needed for the latest
    version) and whose B-tree has interior nodes, key for key."""
    root = many_versions
    dump = ts.ocdbt.dump(ts.KvStore.open("file://" + root + "/").result()) \
        .result()
    assert dump["version_tree_nodes"]
    assert max(v["root_height"] for v in dump["versions"]) > 1
    reader = OcdbtReader(root)
    assert reader.generation == 41 and len(reader.keys()) == 40
    _assert_store_equal(reader, _ts_kvstore(root))


def _node_file(root: str) -> str:
    """The B-tree node file of an orbax step's top-level database."""
    names = os.listdir(os.path.join(root, "d"))
    assert len(names) == 1
    return os.path.join(root, "d", names[0])


def _flip_crc(path):
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))


def _flip_body(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)


def _bad_magic(path):
    data = bytearray(open(path, "rb").read())
    data[0] ^= 0xFF
    open(path, "wb").write(bytes(data))


FAULTS = {
    # name: (file to damage, damage, message)
    "manifest_crc": (lambda r: os.path.join(r, "manifest.ocdbt"), _flip_crc,
                     "crc32c mismatch"),
    "manifest_body": (lambda r: os.path.join(r, "manifest.ocdbt"),
                      _flip_body, "crc32c mismatch"),
    "manifest_truncated": (lambda r: os.path.join(r, "manifest.ocdbt"),
                           _truncate, "length field"),
    "node_crc": (_node_file, _flip_crc, "crc32c mismatch"),
    "node_truncated": (_node_file, _truncate, "truncated"),
    "node_magic": (_node_file, _bad_magic, "bad magic"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_damaged_store_raises_naming_the_file(fault, jax_run, tmp_path):
    run, _ = jax_run
    step = str(tmp_path / "200")
    shutil.copytree(os.path.join(run, "save", "200"), step)
    root = os.path.join(step, "default")
    which, damage, message = FAULTS[fault]
    path = which(root)
    damage(path)
    with pytest.raises(ValueError, match=message) as err:
        OcdbtReader(root)
    assert os.path.basename(path) in str(err.value)


def test_crc32c_is_castagnoli():
    # RFC 3720's check value for "123456789"
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


ZARR_ARRAYS = {
    # name: (numpy array, chunks, dtype in zarr, compressor)
    "f32_edge_chunks": (np.random.default_rng(0).standard_normal(
        (7, 10, 3)).astype(np.float32), [3, 4, 2], "<f4",
        {"id": "zstd", "level": 1}),
    "bfloat16": (np.random.default_rng(1).standard_normal((5, 9)), [2, 4],
                 "bfloat16", {"id": "zstd", "level": 3}),
    "scalar": (np.float32(2.5), [], "<f4", {"id": "zstd", "level": 1}),
    "int32_uncompressed": (np.arange(-20, 19, dtype=np.int32).reshape(3, 13),
                           [2, 5], "<i4", None),
    "f64_one_chunk": (np.linspace(-1, 1, 12).reshape(3, 4), [3, 4], "<f8",
                      {"id": "zstd", "level": 19}),
}


@pytest.mark.parametrize("name", list(ZARR_ARRAYS))
def test_zarr_reader_equals_tensorstore(name, tmp_path):
    """An array written by tensorstore's zarr driver into an OCDBT store
    (chunks smaller than the shape, edge chunks clipped; bfloat16 widened
    to f32; a scalar; no compressor) reads as tensorstore reads it."""
    value, chunks, dtype, compressor = ZARR_ARRAYS[name]
    root = str(tmp_path)
    meta = {"chunks": chunks, "dtype": dtype, "compressor": compressor,
            "dimension_separator": "."}
    meta["shape"] = list(np.shape(value))
    arr = ts.open({"driver": "zarr", "metadata": meta, "create": True,
                   "kvstore": {"driver": "ocdbt",
                               "base": "file://" + root + "/",
                               "path": "params.w/"}}).result()
    arr.write(np.asarray(value).astype(arr.dtype.numpy_dtype)).result()
    want = np.asarray(arr.read().result())
    if dtype == "bfloat16":
        want = want.astype(np.float32)
    got = orbax_reader._read_array(OcdbtReader(root), "params.w", root)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_read_params_tree_equals_jax_params(jax_run):
    """Every step of the JAX save, read with no orbax, equals the params
    it saved, leaf for leaf, at tolerance 0; the names are the npz
    tree's."""
    run, params = jax_run
    for sub, step in (("save", 100), ("save", 200), ("best", 150)):
        got = read_params_tree(os.path.join(run, sub, str(step)))
        _assert_trees_equal(got, _numpy(params[step]))
    assert "kernel" in got["scales"]["1"]["dec_class"]


def test_load_checkpoint_prunes_as_the_jax_restore(jax_run):
    """The (1,1) save directory loaded at (1,0): the names and values of
    the JAX package's own ``restore_params_from``, name for name."""
    run, _ = jax_run
    save = os.path.join(run, "save")
    template = _numpy(_tiny_params((True, False), 9))
    want = params_from_jax(_numpy(restore_params_from(save, template)))
    got = load_checkpoint(save, Multiverse.init(_port_cfg()))
    got_named = dict(got.named_parameters())
    want_named = dict(want.named_parameters())
    assert sorted(got_named) == sorted(want_named)
    for n, p in want_named.items():
        assert torch.equal(got_named[n], p), n
    assert not any(n.startswith("scales.1.") for n in got_named)


def test_published_width_read_equals_jax_params(tmp_path):
    """The published configuration (use_grids 1,1: 21,337,728
    parameters) saved by the JAX CheckpointManager reads equal to the
    JAX params at tolerance 0."""
    cfg = JaxConfig(use_grids=(True, True)).validate()
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    n = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    assert n == 21_337_728
    JaxCheckpointManager(str(tmp_path)).save(7, params)
    step = os.path.join(str(tmp_path), "save", "7")
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(step) for f in fs)
    t0 = time.perf_counter()
    got = read_params_tree(step)
    seconds = time.perf_counter() - t0
    _assert_trees_equal(got, _numpy(params))
    # the decoders alone on the same chunks: the port's and zstandard's
    db = OcdbtReader(os.path.join(step, "default"))
    chunks = [(db.read(k), 4 * int(np.prod(json.loads(db.read(
        k.rsplit(b"/", 1)[0] + b"/.zarray"))["chunks"])))
        for k in db.keys() if not k.endswith(b".zarray")]
    t0 = time.perf_counter()
    for raw, size in chunks:
        zstd.decompress(raw, size)
    ours = time.perf_counter() - t0
    t0 = time.perf_counter()
    for raw, size in chunks:
        zstandard.ZstdDecompressor().decompress(raw, max_output_size=size)
    theirs = time.perf_counter() - t0
    print("published width on this host's CPU (no card): %d parameters, "
          "%d bytes on disk; read_params_tree %.3f s (%.1f MB/s of f32); "
          "the %d chunks' %d zstd bytes decoded by the port's decoder in "
          "%.3f s, by zstandard in %.3f s"
          % (n, nbytes, seconds, 4 * n / seconds / 1e6, len(chunks),
             sum(len(r) for r, _ in chunks), ours, theirs))


def test_list_steps_over_npz_and_orbax_steps(jax_run, tmp_path):
    """A directory that mixes an npz step of the port's earlier runs, the
    port's orbax steps and the JAX package's lists them all by step; an
    orbax step in flight and a directory without its metadata are not
    steps; one step number held twice raises naming both;
    ``latest_step`` and ``resolve_checkpoint`` follow the union."""
    run, _ = jax_run
    save = tmp_path / "save"
    shutil.copytree(os.path.join(run, "save"), str(save))
    cfg = _port_cfg()
    mgr = CheckpointManager(str(tmp_path))
    save_params_npz(Multiverse.init(cfg, seed=1),
                    str(save / "step_00000150.npz"))
    shutil.copytree(str(save / "200"),
                    str(save / "300.orbax-checkpoint-tmp-1692"))
    (save / "400").mkdir()
    assert [s for s, _ in list_steps(str(save))] == [100, 150, 200]
    assert [s for s, _ in orbax_steps(str(save))] == [100, 200]
    assert not is_orbax_step(str(save / "400"))
    assert mgr.latest_step() == 200
    assert resolve_checkpoint(str(save)) == str(save / "200")
    assert resolve_checkpoint(str(save / "100")) == str(save / "100")
    mgr.save(250, Multiverse.init(cfg, seed=2))
    assert resolve_checkpoint(str(save)) == str(save / "250")
    assert [s for s, _ in orbax_steps(str(save))] == [100, 200, 250]
    save_params_npz(Multiverse.init(cfg, seed=3),
                    str(save / "step_00000200.npz"))
    with pytest.raises(ValueError, match="step 200 is held twice"):
        list_steps(str(save))


def test_max_to_keep_never_removes_an_orbax_step(jax_run, tmp_path):
    """``CheckpointManager.save`` with max_to_keep 1 counts and removes
    only the port's own steps: every JAX step stays, whole."""
    run, _ = jax_run
    shutil.copytree(os.path.join(run, "save"), str(tmp_path / "save"))
    before = sorted(os.listdir(tmp_path / "save" / "100" / "default"))
    cfg = _port_cfg()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for step in (300, 310, 320):
        mgr.save(step, Multiverse.init(cfg, seed=step))
    assert [s for s, _ in list_steps(mgr.save_dir)] == [100, 200, 320]
    assert sorted(os.listdir(tmp_path / "save" / "100" / "default")) \
        == before
    read_params_tree(str(tmp_path / "save" / "100"))


def _edit_metadata(step, edit):
    path = os.path.join(step, "default", "_METADATA")
    with open(path) as f:
        meta = json.load(f)
    edit(meta)
    with open(path, "w") as f:
        json.dump(meta, f)


def _key_type(meta):
    key = next(iter(meta["tree_metadata"]))
    meta["tree_metadata"][key]["key_metadata"][0]["key_type"] = 1


REFUSED = {
    "zarr3": (lambda m: m.update(use_zarr3=True), "zarr3"),
    "no_ocdbt": (lambda m: m.update(use_ocdbt=False), "without OCDBT"),
    "sequence_key": (_key_type, "key of type 1"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_read_params_tree_refuses_layouts_the_jax_package_never_writes(
        case, jax_run, tmp_path):
    run, _ = jax_run
    step = str(tmp_path / "100")
    shutil.copytree(os.path.join(run, "save", "100"), step)
    edit, message = REFUSED[case]
    _edit_metadata(step, edit)
    with pytest.raises(ValueError, match=message):
        read_params_tree(step)


def test_a_missing_chunk_raises(tmp_path):
    """A chunk the array's metadata implies but the store lacks."""
    root = str(tmp_path)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + root + "/"}).result()
    meta = {"chunks": [2], "compressor": None, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None,
            "order": "C", "shape": [4], "zarr_format": 2}
    kv.write(b"params.w/.zarray", json.dumps(meta).encode()).result()
    kv.write(b"params.w/0", np.ones(2, np.float32).tobytes()).result()
    with pytest.raises(ValueError, match="chunk params.w/1 is missing"):
        orbax_reader._read_array(OcdbtReader(root), "params.w", root)


def test_the_committed_fixture_reads_equal_to_expected():
    """tests/torch_fixtures/jax_run (written by tests/make_jax_fixture.py
    with the JAX CheckpointManager, at the published widths with both
    grid scales) reads equal to the leaves that chip_smoke.fixture_leaf
    makes from its seed, at tolerance 0, and loads through
    ``load_checkpoint`` at the default ``use_grids 1,0`` equal to those
    leaves pruned."""
    save = os.path.join(FIXTURE, "multiverse", "00", "save")
    full = MultiverseConfig(use_gnn=True, use_scene_enc=True,
                            use_grids=FIXTURE_GRIDS).validate()
    want = _flat(fixture_tree(Multiverse.init(full)))
    got = _flat(read_checkpoint_tree(save))
    assert sorted(got) == sorted(want)
    assert sum(v.size for v in got.values()) == 21_337_728
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = MultiverseConfig(use_gnn=True, use_scene_enc=True).validate()
    model = load_checkpoint(save, Multiverse.init(cfg))
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 18
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[n.replace(".", "/")], err_msg=n)
    # the step stays a few MB
    step = os.path.join(save, "120")
    assert sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(step) for f in fs) < 4 << 20


def test_bfloat16_leaves_of_a_jax_save(tmp_path):
    """A bf16 leaf saved by the JAX CheckpointManager reads as the f32
    of the same value."""
    params = {"a": {"kernel": jnp.asarray(np.random.default_rng(3)
                                          .standard_normal((4, 6)),
                                          jnp.bfloat16)},
              "b": jnp.asarray(1.5, jnp.float32)}
    JaxCheckpointManager(str(tmp_path)).save(1, params)
    got = read_params_tree(str(tmp_path / "save" / "1"))
    np.testing.assert_array_equal(
        got["a"]["kernel"], np.asarray(params["a"]["kernel"].astype(
            jnp.float32)))
    assert got["b"].shape == () and got["b"] == 1.5
