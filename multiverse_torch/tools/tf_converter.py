"""Convert the reference's released TF1 checkpoints to the port's
parameter tree — the port's copy of ``multiverse_tpu/tools/
tf_converter.py``, reading the checkpoint with no tensorflow.

Name mapping — reference variable scopes → param paths.  The full
names below are the graph's REAL names, derived from the reference's
scope structure (reference: code/pred_models.py:140-306 build_forward,
:311-471 grid_decoder, :925-959 hidden2grid; SimAug/code/pred_models.py
uses identical names) and verified against TF's actual scope mechanics:
`dynamic_rnn(scope=s)` replaces the default "rnn" scope (no extra
segment), `raw_rnn(scope="decoder_rnn")` nests the cell variables AND
any variables created inside the loop_fn (the decoder's `grid_emb`)
under `decoder_rnn/`, and `variable_scope(top_scope)` rebases the
`hidden2grid_*` convs to directly under `person_pred/`:

    person_pred/scene_conv{k}/W,b                      scene_conv{k}
    person_pred/encoder_grid_class_{i}/enc_grid_{i}/kernel,biases
                                                       scales[i].enc_class
    person_pred/encoder_grid_reg_{i}/enc_grid_regress_{i}/kernel,biases
                                                       scales[i].enc_reg
    person_pred/decoder_grid_class_{i}/decoder_rnn/dec_grid_{i}/kernel,biases
                                                       scales[i].dec_class
    person_pred/decoder_grid_reg_{i}/decoder_rnn/dec_grid_reg_{i}/kernel,biases
                                                       scales[i].dec_reg
    person_pred/decoder_grid_class_{i}/decoder_rnn/grid_emb/W,b
                                                       scales[i].dec_class_emb
    person_pred/decoder_grid_reg_{i}/decoder_rnn/grid_emb/W,b
                                                       scales[i].dec_reg_emb
    person_pred/hidden2grid_decoder_grid_class_{i}/out_dec_grid/W
                                                       scales[i].h2g_class
    person_pred/hidden2grid_decoder_grid_reg_{i}/out_dec_grid/W
                                                       scales[i].h2g_reg
    person_pred/decode_reg/out_dec_grid/W              scales[i].h2g_single
    person_pred/grid_emb/W,b (no-scene-enc encoder)    scales[i].enc_grid_emb

The GNN (`gnn_edge`/`gnn_node`/`gnn_mask_edge`, reference
pred_models.py:808-909) creates NO trainable variables — it is
l2-normalize + matmul + masked softmax — so nothing maps from the
`gnn_*` scopes.  Matching is by scope-suffix patterns with the
`decoder_rnn/` segment optional, so either nesting converts.  Layouts
need no transposition: TF conv kernels are HWIO like ours, the contrib
ConvLSTMCell's fused kernel is [k, k, in+h, 4h] with gate order
(i, g, f, o) — the order our cell implements (verified against the
TF 1.15 contrib source; see multiverse_torch/ops/convlstm.py).

The checkpoint is read by :mod:`.tf_bundle` (the subset of
`tf.train.load_checkpoint` the JAX package's converter uses), and the
parameters are filled into a nested dict of numpy arrays in the names
of `bridge.params_to_numpy_tree`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.tools.tf_bundle import BundleReader

# (regex over the TF variable name, param path template);
# {i} = grid scale index
_RULES: List[Tuple[str, Tuple[str, ...]]] = [
    (r"scene_conv(?P<k>\d+)/W$", ("scene_conv{k}", "w")),
    (r"scene_conv(?P<k>\d+)/b$", ("scene_conv{k}", "b")),
    (r"enc_grid_(?P<i>\d+)/kernel$",
     ("scales", "{i}", "enc_class", "kernel")),
    (r"enc_grid_(?P<i>\d+)/biases$",
     ("scales", "{i}", "enc_class", "bias")),
    (r"enc_grid_regress_(?P<i>\d+)/kernel$",
     ("scales", "{i}", "enc_reg", "kernel")),
    (r"enc_grid_regress_(?P<i>\d+)/biases$",
     ("scales", "{i}", "enc_reg", "bias")),
    (r"dec_grid_(?P<i>\d+)/kernel$",
     ("scales", "{i}", "dec_class", "kernel")),
    (r"dec_grid_(?P<i>\d+)/biases$",
     ("scales", "{i}", "dec_class", "bias")),
    (r"dec_grid_reg_(?P<i>\d+)/kernel$",
     ("scales", "{i}", "dec_reg", "kernel")),
    (r"dec_grid_reg_(?P<i>\d+)/biases$",
     ("scales", "{i}", "dec_reg", "bias")),
    (r"decoder_grid_class_(?P<i>\d+)/(?:decoder_rnn/)?grid_emb/W$",
     ("scales", "{i}", "dec_class_emb", "w")),
    (r"decoder_grid_class_(?P<i>\d+)/(?:decoder_rnn/)?grid_emb/b$",
     ("scales", "{i}", "dec_class_emb", "b")),
    (r"decoder_grid_reg_(?P<i>\d+)/(?:decoder_rnn/)?grid_emb/W$",
     ("scales", "{i}", "dec_reg_emb", "w")),
    (r"decoder_grid_reg_(?P<i>\d+)/(?:decoder_rnn/)?grid_emb/b$",
     ("scales", "{i}", "dec_reg_emb", "b")),
    (r"hidden2grid_decoder_grid_class_(?P<i>\d+)/out_dec_grid/W$",
     ("scales", "{i}", "h2g_class", "w")),
    (r"hidden2grid_decoder_grid_reg_(?P<i>\d+)/out_dec_grid/W$",
     ("scales", "{i}", "h2g_reg", "w")),
    (r"decode_reg/out_dec_grid/W$",
     ("scales", "{active}", "h2g_single", "w")),
    (r"(?:^|person_pred/)grid_emb/W$",
     ("scales", "{active}", "enc_grid_emb", "w")),
    (r"(?:^|person_pred/)grid_emb/b$",
     ("scales", "{active}", "enc_grid_emb", "b")),
]

_SKIP = re.compile(
    r"(global_step|Adadelta|Adam|Momentum|RMSProp|beta\d_power)")


def map_variable(name: str, cfg: MultiverseConfig
                 ) -> Optional[Tuple[str, ...]]:
    """TF variable name → param path tuple, or None (optimizer slots,
    unknown auxiliaries)."""
    if _SKIP.search(name):
        return None
    for pattern, path in _RULES:
        m = re.search(pattern, name)
        if m:
            gd = m.groupdict()
            sub = {
                "k": gd.get("k", ""),
                "i": gd.get("i", ""),
                "active": str(cfg.active_scales[0]),
            }
            return tuple(p.format(**sub) for p in path)
    return None


def map_reference_variables(
    var_names: List[str], cfg: MultiverseConfig
) -> Dict[str, Tuple[str, ...]]:
    """Map every checkpoint variable; raises when two variables claim
    the same parameter."""
    out: Dict[str, Tuple[str, ...]] = {}
    used: Dict[Tuple[str, ...], str] = {}
    for name in var_names:
        path = map_variable(name, cfg)
        if path is None:
            continue
        if path in used:
            raise ValueError(
                f"{name} and {used[path]} both map to {path}")
        used[path] = name
        out[name] = path
    return out


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    if path[-1] not in node:
        raise KeyError("param tree has no leaf %s" % (path,))
    expected = node[path[-1]].shape
    if tuple(value.shape) != tuple(expected):
        raise ValueError(
            f"shape mismatch at {path}: ckpt {value.shape} "
            f"vs params {expected}")
    node[path[-1]] = value


def _leaf_paths(tree: dict, prefix: Tuple[str, ...] = ()):
    """Every leaf's path, keys sorted as jax flattens a dict."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def convert_tf_checkpoint(
    ckpt_path: str,
    cfg: MultiverseConfig,
    params_template: dict,
    strict: bool = True,
) -> dict:
    """Load a reference TF1 checkpoint (a prefix, or a directory with a
    `checkpoint` file) into a nested dict of f32 numpy arrays shaped
    like `params_template` (`bridge.params_to_numpy_tree` of
    `Multiverse.init(cfg)`)."""
    import copy

    reader = BundleReader(ckpt_path)
    names = list(reader.get_variable_to_shape_map())
    mapping = map_reference_variables(names, cfg)

    params = copy.deepcopy(params_template)

    filled = set()
    for name, path in mapping.items():
        value = np.asarray(reader.get_tensor(name), np.float32)
        try:
            _set_path(params, path, value)
        except KeyError:
            if strict:
                raise
            continue  # variable for a variant this config doesn't use
        filled.add(path)

    if strict:
        missing = [path for path in _leaf_paths(params)
                   if path not in filled]
        if missing:
            raise ValueError(
                "checkpoint did not cover params: %s" % missing)
    return params
