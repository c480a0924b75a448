"""The port's SimAug data grouping against the JAX package's on the same
inputs: ``get_agent_id`` (str and bytes keys), ``build_multiview_extras``
(singleton agents padded with the example itself, M from the data or
capped) and ``MultiviewDataset`` batches, field for field and in the
same shuffle order, on one npz written by
``synthesize_multiview_prepro``."""

import numpy as np
import pytest

from multiverse_tpu.data import multiview as J
from multiverse_tpu.data.dataset import read_data as jax_read_data
from multiverse_tpu.models.simaug import SimAugConfig as JaxSimAugConfig
from multiverse_torch.data import multiview as T
from multiverse_torch.data.dataset import read_data
from multiverse_torch.models.simaug import SimAugConfig

KEYS = [
    "VIRAT_S_0400_F_1879_obs12_pred16_cam1_84_4",
    "VIRAT_S_0400_F_1879_obs12_pred16_cam2_84_4",
    b"VIRAT_S_0400_F_1879_obs12_pred16_cam3_84_4",
    "VIRAT_S_0400_F_1879_obs12_pred16_cam1_85_2",
    b"VIRAT_S_0401_F_12_obs12_pred16_cam4_9_1",
]
DIMS = dict(obs_len=4, pred_len=5, scene_h=12, scene_w=16, scene_class=5,
            emb_size=8, enc_hidden_size=16, dec_hidden_size=16,
            scene_conv_dim=8, multiview_train=True, batch_size=4)


def test_agent_ids_match_jax():
    ids = [T.get_agent_id(k) for k in KEYS]
    assert ids == [J.get_agent_id(k) for k in KEYS]
    assert ids[0] == ids[1] == ids[2] != ids[3]
    assert ids[4] == "VIRAT_S_0401_F_12_obs12_pred16_9_1"


@pytest.mark.parametrize("max_views", [0, 1, 2, 4])
def test_multiview_extras_match_jax(max_views):
    rng = np.random.RandomState(0)
    obs = rng.randint(0, 48, (5, 4)).astype(np.int32)
    pred = rng.randint(0, 48, (5, 5)).astype(np.int32)
    scn = rng.randint(0, 3, (5, 4)).astype(np.int32)
    got = T.build_multiview_extras(KEYS, obs, pred, scn, max_views)
    want = J.build_multiview_extras(KEYS, obs, pred, scn, max_views)
    assert got.num_views == want.num_views == (max_views or 2)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    # the singleton agents pad with themselves
    np.testing.assert_array_equal(got.obs_grid_class_extra[3, 0], obs[3])
    np.testing.assert_array_equal(got.pred_grid_class_extra[4, -1], pred[4])


@pytest.fixture(scope="module")
def prepro(tmp_path_factory):
    cfg = SimAugConfig(**DIMS).validate()
    # 7 agents x 4 cameras, and one agent seen by one camera only
    path = str(tmp_path_factory.mktemp("multiview"))
    arrays = T.synthesize_multiview_split(cfg, 7, seed=3)
    arrays["seq_key"][-1] = "synthetic_S_0000_F_999_obs4_pred5_cam1_99_99"
    np.savez(path + "/data_train.npz", **arrays)
    return cfg, path


@pytest.mark.parametrize("max_views", [3, 2])
def test_multiview_batches_match_jax(prepro, max_views):
    cfg, path = prepro
    jcfg = JaxSimAugConfig(**DIMS).validate()
    t_ds = T.MultiviewDataset(read_data(path, "train", cfg), cfg, max_views)
    j_ds = J.MultiviewDataset(jax_read_data(path, "train", jcfg), jcfg,
                              max_views)
    assert t_ds.num_views == j_ds.num_views == max_views
    pairs = list(zip(t_ds.get_batches(8, num_steps=5),
                     j_ds.get_batches(8, num_steps=5)))
    assert len(pairs) == 5
    for (tb, tx), (jb, jx) in pairs:
        assert tb._fields == jb._fields
        for name, a, b in zip(tb._fields, tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert tb.scene_feat.dtype == np.uint8
        np.testing.assert_array_equal(tx["pred_traj"], jx["pred_traj"])
        assert tx["original_batch_size"] == jx["original_batch_size"]
    # an agent's extra views are its other cameras: the first example's
    # extras are examples 1..M (its cameras 2..M+1)
    batch, _ = t_ds.make_batch([0])
    data = t_ds.base.data
    np.testing.assert_array_equal(
        batch.pred_grid_class_extra[0],
        data["pred_grid_class"][1:max_views + 1, 0])
