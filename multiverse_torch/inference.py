"""Multi-future inference: batched diverse-beam (or greedy) decode over
Forking Paths observation trajectories.

PyTorch port of ``multiverse_tpu/inference.py``.
The output files keep the reference pickle contracts, so the evaluators
of ``multiverse_tpu/eval`` read them unchanged:

    output_file:    {traj_id: [num_out][T][2]}
    save_prob_file: {traj_id: (beam_logits [1, K, T, H*W] f32,
                               beam_logprobs [1, K] f32)}
"""

from __future__ import annotations

import glob
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiverse_torch.config import MultiverseConfig
from multiverse_torch.data import scene as scene_lib
from multiverse_torch.data.dataset import batch_to_device
from multiverse_torch.decode_graphs import (
    GraphCache,
    graph_cache,
    graph_key,
    graphs_apply,
)
from multiverse_torch.geometry import (
    grid_centers,
    one_hot_grid,
    rasterize_traj_np,
)
from multiverse_torch.models.beam_search import (
    BeamOutputs,
    diverse_beam_search,
)
from multiverse_torch.models.multiverse import (
    Batch,
    greedy_decode,
    scene_encode,
)
from multiverse_torch.ops import conv2d, convlstm_scan
from multiverse_torch.ops.layers import get_activation
from multiverse_torch.utils import span


# ----------------------------------------------------------- forward


def _encode(params, batch: Batch, cfg: MultiverseConfig, compute_dtype):
    """Scene CNN + class-encoder scan of the single active scale.
    Returns (obs one-hot maps [N, T_obs, h, w, 1], encoder last state,
    scene mean [N, h, w, C] or None)."""
    act = get_activation(cfg.activation)
    N, _, T_obs = batch.obs_grid_class.shape
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    sp = params["scales"][str(i)]

    scene_convs = []
    if cfg.use_scene_enc:
        scene_convs = scene_encode(
            params, batch.scene_feat, batch.obs_scene, cfg, compute_dtype)

    obs_onehot = one_hot_grid(batch.obs_grid_class[:, i], h, w)
    if cfg.use_scene_enc:
        enc_in = scene_convs[i] * obs_onehot
    else:
        flat = obs_onehot.reshape(N * T_obs, h, w, 1)
        emb = conv2d(sp["enc_grid_emb"], flat, activation=act,
                     compute_dtype=compute_dtype)
        enc_in = emb.reshape(N, T_obs, h, w, -1)
    _, enc_last = convlstm_scan(sp["enc_class"], enc_in,
                                compute_dtype=compute_dtype)

    scene_mean = None
    if cfg.use_scene_enc and cfg.use_gnn:
        scene_mean = torch.mean(scene_convs[i], dim=1)
    return obs_onehot, enc_last, scene_mean


def _encode_weights(params, cfg: MultiverseConfig) -> list:
    """The parameters ``_encode`` reads."""
    sp = params["scales"][str(cfg.active_scales[0])]
    mods = [sp["enc_class"]]
    if cfg.use_scene_enc:
        mods += [params[f"scene_conv{i + 1}"] for i in range(cfg.num_scales)]
    else:
        mods.append(sp["enc_grid_emb"])
    return [p for m in mods for p in m.parameters()]


def _reg_weights(params, cfg: MultiverseConfig) -> list:
    """The parameters the regression encoder and decoder read."""
    sp = params["scales"][str(cfg.active_scales[0])]
    return [p for name in ("enc_reg", "dec_reg_emb", "dec_reg", "h2g_reg")
            for p in sp[name].parameters()]


def _encode_part(params, batch: Batch, cfg: MultiverseConfig,
                 compute_dtype, graphs: Optional[GraphCache]):
    """``_encode``, replayed from ``graphs`` where they apply."""
    def fn(obs_grid_class, obs_scene, scene_feat):
        return _encode(params, Batch(obs_grid_class, (), obs_scene,
                                     scene_feat), cfg, compute_dtype)

    inputs = (batch.obs_grid_class, batch.obs_scene, batch.scene_feat)
    if not graphs_apply(graphs, inputs):
        return fn(*inputs)
    return graphs.run(graph_key("encode", cfg, 0, inputs,
                                _encode_weights(params, cfg)), fn, inputs)


def _reg_ahead(params, batch: Batch, cfg: MultiverseConfig, T: int,
               compute_dtype, graphs: Optional[GraphCache]):
    """The regression head replayed from ``graphs``, where they apply, on
    their side stream: it reads only the batch, so it runs under the
    encoders and the class decode, and is read after ``graphs.join``.
    None where it runs eagerly after the class decode (no graphs, or the
    single decoder, whose head reads the decode's states)."""
    target = batch.obs_grid_target_all[0]
    if cfg.use_single_decoder or not graphs_apply(graphs, (target,)):
        return None

    def fn(obs_target):
        return _reg_decode(params, Batch(None, (obs_target,), None, None),
                           cfg, None, T, compute_dtype)

    with span("decode.reg"):
        return graphs.run(graph_key("reg", cfg, T, (target,),
                                    _reg_weights(params, cfg)),
                          fn, (target,), side=True)


def _compute_dtype(cfg: MultiverseConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def beam_forward(
    params,
    batch: Batch,
    cfg: MultiverseConfig,
    T_pred: Optional[int] = None,
    *,
    graphs: Optional[GraphCache] = None,
) -> Tuple[BeamOutputs, torch.Tensor]:
    """Encoders + diverse beam decode + greedy regression decode for the
    single active scale. Returns (BeamOutputs, reg_out [N, T, h, w, 2]).

    ``graphs`` (the offline decode's, :mod:`multiverse_torch.decode_graphs`):
    the encoders and the regression head run as replays of CUDA graphs,
    their outputs overwritten by the next replay; the head's on a side
    stream under the encoders and the search, which the current stream
    waits for before returning."""
    cfg.validate()
    T = T_pred or cfg.pred_len
    compute_dtype = _compute_dtype(cfg)
    reg = _reg_ahead(params, batch, cfg, T, compute_dtype, graphs)
    with span("decode.encode"):
        obs_onehot, enc_last, scene_mean = _encode_part(
            params, batch, cfg, compute_dtype, graphs)
    sp = params["scales"][str(cfg.active_scales[0])]
    beam = diverse_beam_search(
        sp, cfg,
        first_input=obs_onehot[:, -1],
        init_state=enc_last,
        T_pred=T,
        pred_length=batch.pred_length,
        scene_mean=scene_mean,
        save_states=cfg.use_single_decoder,
        compute_dtype=compute_dtype,
    )
    if reg is not None:
        graphs.join(beam.ids.device)
        return beam, reg
    with span("decode.reg"):
        reg = _reg_decode(params, batch, cfg, beam.states, T, compute_dtype)
    return beam, reg


def greedy_forward(
    params,
    batch: Batch,
    cfg: MultiverseConfig,
    T_pred: Optional[int] = None,
    *,
    graphs: Optional[GraphCache] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoders + greedy class decode + greedy regression decode (the
    ``--greedy`` path). The class decode runs the fused decode step on
    the bf16 GNN path (K1, or K2/K3/K7 under ``cfg.decode_quant``).
    Returns (class logits [N, T, h, w, 1], reg [N, T, h, w, 2]).
    ``graphs``: as in :func:`beam_forward`."""
    cfg = cfg.replace(use_beam_search=False).validate()
    T = T_pred or cfg.pred_len
    compute_dtype = _compute_dtype(cfg)
    reg = _reg_ahead(params, batch, cfg, T, compute_dtype, graphs)
    with span("decode.encode"):
        obs_onehot, enc_last, scene_mean = _encode_part(
            params, batch, cfg, compute_dtype, graphs)
    sp = params["scales"][str(cfg.active_scales[0])]
    logits, states = greedy_decode(
        sp, cfg,
        first_input=obs_onehot[:, -1],
        init_state=enc_last,
        T_pred=T,
        emb_name="dec_class_emb",
        cell_name="dec_class",
        h2g_name="h2g_class",
        use_gnn=cfg.use_gnn,
        scene_mean=scene_mean,
        feedback="onehot",
        compute_dtype=compute_dtype,
        allow_fused=True,
    )
    if reg is not None:
        graphs.join(logits.device)
        return logits, reg
    # the single decoder's regression reads the best (here: only)
    # decode's states, [N, T, h, w, D]
    states = states[:, None] if cfg.use_single_decoder else None
    with span("decode.reg"):
        reg = _reg_decode(params, batch, cfg, states, T, compute_dtype)
    return logits, reg


def _reg_decode(params, batch, cfg, states, T, compute_dtype):
    """The regression head: with a single decoder, read out of the best
    beam's decoder states (``states`` [N, K, T, h, w, D]); otherwise the
    regression encoder and its greedy raw-feedback decoder."""
    N = batch.obs_grid_target_all[0].shape[0]
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    sp = params["scales"][str(i)]
    if cfg.use_single_decoder:
        D = states.shape[-1]
        best_states = states[:, 0].reshape(N * T, h, w, D)
        reg = conv2d(sp["h2g_single"], best_states,
                     compute_dtype=compute_dtype)
        return reg.reshape(N, T, h, w, 2)
    _, enc_reg_last = convlstm_scan(
        sp["enc_reg"], batch.obs_grid_target_all[0],
        compute_dtype=compute_dtype)
    reg_out, _ = greedy_decode(
        sp, cfg,
        first_input=batch.obs_grid_target_all[0][:, -1],
        init_state=enc_reg_last,
        T_pred=T,
        emb_name="dec_reg_emb",
        cell_name="dec_reg",
        h2g_name="h2g_reg",
        use_gnn=False,
        feedback="raw",
        compute_dtype=compute_dtype,
    )
    return reg_out


# ------------------------------------------------------------- inputs


class MultifutureInputs(NamedTuple):
    """Host-side arrays for one inference run (all trajectories)."""

    traj_ids: List[str]
    obs_traj: np.ndarray          # [N, T_obs, 2] float32
    obs_grid_class: np.ndarray    # [N, S, T_obs] int32
    obs_grid_target: List[np.ndarray]  # per scale [N, T_obs, h, w, 2]
    obs_scene: np.ndarray         # [N, T_obs] int32
    scene_feat: np.ndarray        # [F, SH, SW, C] uint8
    pred_lengths: np.ndarray      # [N] int32 (max over GT futures)


def load_multifuture_inputs(
    traj_path: str,
    multifuture_path: str,
    scene_feat_path: str,
    scene_id2name: str,
    cfg: MultiverseConfig,
) -> MultifutureInputs:
    """Load Forking Paths obs TSVs + per-frame scene segmentation npys
    (reference: code/multifuture_inference.py:158-272 ``get_inputs``)."""
    oldid2new, num_classes = scene_lib.load_scene_id_map(scene_id2name)
    table = scene_lib.remap_table(oldid2new)

    traj_files = sorted(glob.glob(os.path.join(traj_path, "*.txt")))
    traj_ids, obs_list, cls_list, tgt_list = [], [], [], []
    scene_idx_list, pred_len_list = [], []
    scene_rows: List[np.ndarray] = []

    for traj_file in traj_files:
        traj_id = os.path.splitext(os.path.basename(traj_file))[0]
        _, _, x_agent_pid, _ = traj_id.split("_")
        data = np.loadtxt(traj_file, delimiter="\t", dtype=np.float32)
        frame_idxs = np.unique(data[:, 0])
        obs = data[data[:, 1] == float(int(x_agent_pid)), 2:]
        if len(obs) != cfg.obs_len:
            raise ValueError(
                f"{traj_id}: obs length {len(obs)} != {cfg.obs_len}")

        cls, tgt = rasterize_traj_np(
            obs, cfg.video_h, cfg.video_w, cfg.scene_grids)

        idxs = np.zeros(cfg.obs_len, np.int32)
        for t, fidx in enumerate(frame_idxs[:cfg.obs_len]):
            npy = os.path.join(
                scene_feat_path, traj_id,
                "%s_F_%08d.npy" % (traj_id, int(fidx)))
            idxs[t] = len(scene_rows)
            scene_rows.append(np.load(npy))

        with open(os.path.join(
                multifuture_path, "%s.p" % traj_id), "rb") as f:
            gt = pickle.load(f)
        pred_len = max(len(gt[fid]["x_agent_traj"]) for fid in gt)

        traj_ids.append(traj_id)
        obs_list.append(obs)
        cls_list.append(cls)
        tgt_list.append(tgt)
        scene_idx_list.append(idxs)
        pred_len_list.append(pred_len)

    scene_feat = scene_lib.scene_class_map_to_onehot(
        np.stack(scene_rows), table, num_classes)
    return MultifutureInputs(
        traj_ids=traj_ids,
        obs_traj=np.stack(obs_list),
        obs_grid_class=np.stack(cls_list),
        obs_grid_target=[np.stack([t[i] for t in tgt_list])
                         for i in range(cfg.num_scales)],
        obs_scene=np.stack(scene_idx_list),
        scene_feat=scene_feat,
        pred_lengths=np.asarray(pred_len_list, np.int32),
    )


def synthesize_multifuture_inputs(
    cfg: MultiverseConfig,
    num_traj: int,
    seed: int = 0,
    max_pred_len: int = 25,
) -> MultifutureInputs:
    """Random-walk inputs with the shapes of a real run, made from
    ``seed`` with numpy (the same arrays as the JAX package's function
    of the same name)."""
    rnd = np.random.RandomState(seed)
    start = rnd.uniform(
        [cfg.video_w * 0.2, cfg.video_h * 0.2],
        [cfg.video_w * 0.8, cfg.video_h * 0.8],
        size=(num_traj, 1, 2))
    steps = rnd.normal(0.0, 25.0, size=(num_traj, cfg.obs_len, 2))
    obs = (start + np.cumsum(steps, axis=1)).astype(np.float32)
    obs[..., 0] = np.clip(obs[..., 0], 1.0, cfg.video_w - 1.0)
    obs[..., 1] = np.clip(obs[..., 1], 1.0, cfg.video_h - 1.0)

    cls = np.zeros((num_traj, cfg.num_scales, cfg.obs_len), np.int32)
    tgts = [np.zeros((num_traj, cfg.obs_len, h, w, 2), np.float32)
            for (h, w) in cfg.scene_grids]
    for n in range(num_traj):
        c, t = rasterize_traj_np(
            obs[n], cfg.video_h, cfg.video_w, cfg.scene_grids)
        cls[n] = c
        for i in range(cfg.num_scales):
            tgts[i][n] = t[i]

    F = max(1, num_traj // 2)
    scene_feat = np.zeros(
        (F, cfg.scene_h, cfg.scene_w, cfg.scene_class), np.uint8)
    labels = rnd.randint(0, cfg.scene_class,
                         size=(F, cfg.scene_h, cfg.scene_w))
    scene_feat[
        np.arange(F)[:, None, None],
        np.arange(cfg.scene_h)[None, :, None],
        np.arange(cfg.scene_w)[None, None, :],
        labels] = 1
    obs_scene = rnd.randint(
        0, F, size=(num_traj, cfg.obs_len)).astype(np.int32)
    pred_lengths = rnd.randint(
        cfg.pred_len, max_pred_len + 1, size=num_traj).astype(np.int32)
    return MultifutureInputs(
        traj_ids=["scene_%04d_%d_cam1" % (n, n) for n in range(num_traj)],
        obs_traj=obs,
        obs_grid_class=cls,
        obs_grid_target=tgts,
        obs_scene=obs_scene,
        scene_feat=scene_feat,
        pred_lengths=pred_lengths,
    )


# ---------------------------------------------------------- offline run


def make_batch(
    inputs: MultifutureInputs,
    idxs: np.ndarray,
    cfg: MultiverseConfig,
) -> Batch:
    """A numpy Batch for the given trajectory indices. Only the scene
    rows the batch references are packed, remapped to first-seen order
    and zero-padded to a fixed n*T_obs rows."""
    from multiverse_torch import native

    scale0 = cfg.active_scales[0]
    obs_scene_old = inputs.obs_scene[idxs]
    cap = int(obs_scene_old.size)
    new_idx, old_rows, _ = native.remap_first_seen(
        obs_scene_old.astype(np.int32), cap,
        max_id=len(inputs.scene_feat) - 1)
    table = native.gather_rows(inputs.scene_feat, old_rows, cap)
    return Batch(
        obs_grid_class=inputs.obs_grid_class[idxs],
        obs_grid_target_all=(inputs.obs_grid_target[scale0][idxs],),
        obs_scene=new_idx,
        scene_feat=table,
        pred_length=inputs.pred_lengths[idxs],
    )


def reconstruct_beam_trajs(
    beam_ids: torch.Tensor,     # [N, K, T] grid cells
    reg_out: torch.Tensor,      # [N, T, h, w, 2] offset maps
    centers: torch.Tensor,      # [h*w, 2]
    center_only: bool = False,
) -> torch.Tensor:
    """Beam cells + offset maps -> [N, K, T, 2] absolute points
    (center[beam_cell] + reg[t, beam_cell]), on the device."""
    N, K, T = beam_ids.shape
    HW = reg_out.shape[2] * reg_out.shape[3]
    ids = beam_ids.long()
    pts = centers[ids]                                   # [N, K, T, 2]
    if center_only:
        return pts.float()
    reg = reg_out.reshape(N, T, HW, 2)
    idx = ids.transpose(1, 2)                            # [N, T, K]
    off = torch.gather(reg, 2, idx[..., None].expand(N, T, K, 2))
    return (pts + off.transpose(1, 2)).float()


def reconstruct_greedy_trajs(
    class_logits: torch.Tensor,  # [N, T, h, w, 1]
    reg_out: torch.Tensor,       # [N, T, h, w, 2]
    centers: torch.Tensor,       # [h*w, 2]
    center_only: bool = False,
) -> torch.Tensor:
    """Argmax cells + offsets -> [N, T, 2] absolute points, on the
    device."""
    N, T = class_logits.shape[:2]
    HW = class_logits.shape[2] * class_logits.shape[3]
    sel = torch.argmax(class_logits.reshape(N, T, HW), dim=-1)
    pts = centers[sel]                                   # [N, T, 2]
    if center_only:
        return pts.float()
    reg = reg_out.reshape(N, T, HW, 2)
    off = torch.gather(reg, 2, sel[..., None, None].expand(N, T, 1, 2))
    return (pts + off[:, :, 0]).float()


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path" % str(device))
    return device


def run_multifuture_inference(
    params,
    inputs: MultifutureInputs,
    cfg: MultiverseConfig,
    batch_size: int = 16,
    T_max: Optional[int] = None,
    greedy: bool = False,
    center_only: bool = False,
    need_prob: bool = True,
    prob_fetch_dtype: str = "float32",
    device="cuda",
    timings: Optional[dict] = None,
) -> Tuple[Dict[str, list], Dict[str, tuple]]:
    """Decode every trajectory on ``device``; return (output_data,
    beam_prob) in the reference pickle formats.

    ``greedy=True`` decodes one future per trajectory
    (:func:`greedy_forward`) and writes it ``beam_size`` times, as the
    JAX package does; ``beam_prob`` is then empty (no beams).

    ``params`` is a :class:`~multiverse_torch.models.Multiverse` (moved
    to ``device``). Trajectories are reconstructed on the device;
    ``need_prob=False`` skips fetching the [N, K, T, H*W] beam logits
    (``beam_prob`` is then empty). ``prob_fetch_dtype="float16"`` halves
    the bytes of that fetch; the pickle stays f32.

    Two batches are in flight: while the device decodes batch b, a
    resolver thread waits for batch b-1's copies and packs its pickles.

    On cuda the encoders and the regression head run as CUDA graphs
    (:mod:`multiverse_torch.decode_graphs`), captured the first time a
    batch shape is met (for these parameters, across calls) and replayed
    for every later batch: every batch has the same shapes.

    Every batch decodes ``T_max`` steps (default: the longest GT
    future); a ``T_max`` below a trajectory's future truncates its
    output to ``T_max`` points.

    ``timings``: an optional dict the run adds its per-phase wall time
    to, as the JAX function does: "build_s" (host batch packing and the
    decode's enqueue), "fetch_s" (the blocking wait for the device ->
    host copies: on cuda it includes the device work still running),
    "fetch_bytes" (the bytes copied), "pack_s" (host upcast and
    pickle-format assembly) and "batches".

    Under ``torch.profiler`` each batch records its spans
    (:func:`multiverse_torch.utils.span`), one batch id to all of them:
    ``decode.batch`` (the span of "build_s") over ``decode.make_batch``,
    ``decode.upload``, ``decode.forward`` and ``decode.copy_out``; the
    resolver thread's ``decode.fetch`` and ``decode.pack`` ("fetch_s",
    "pack_s"); the main thread's ``decode.wait`` for the resolver.
    """
    if prob_fetch_dtype not in ("float32", "float16"):
        raise ValueError(
            f"prob_fetch_dtype must be float32|float16, got "
            f"{prob_fetch_dtype!r}")
    device = _resolve_device(device)
    cfg = cfg.replace(use_beam_search=not greedy).validate()
    params = params.to(device)
    i = cfg.active_scales[0]
    h, w = cfg.scene_grids[i]
    centers = torch.as_tensor(
        grid_centers(cfg.video_h, cfg.video_w, h, w).reshape(-1, 2),
        dtype=torch.float32, device=device)
    N = len(inputs.traj_ids)
    T = T_max or int(inputs.pred_lengths.max())
    K = cfg.beam_size
    fetch_dt = torch.float16 if prob_fetch_dtype == "float16" else None
    graphs = graph_cache(params) if device.type == "cuda" else None
    if timings is not None:
        for k in ("build_s", "fetch_s", "fetch_bytes", "pack_s",
                  "batches"):
            timings.setdefault(k, 0.0)

    def dispatch(batch: Batch):
        """Enqueue one batch; return host copies and a ready event."""
        with torch.inference_mode():
            with span("decode.upload"):
                on_device = batch_to_device(batch, device)
            with span("decode.forward"):
                if greedy:
                    logits, reg_out = greedy_forward(params, on_device, cfg,
                                                     T_pred=T, graphs=graphs)
                else:
                    beam, reg_out = beam_forward(params, on_device, cfg,
                                                 T_pred=T, graphs=graphs)
            # on cuda reg_out and the encoders' outputs are the graphs'
            # buffers, which the next batch's replays overwrite: all that
            # reads them is enqueued on this stream, which those replays
            # wait for
            with span("decode.copy_out"):
                if greedy:
                    outs = [reconstruct_greedy_trajs(logits, reg_out,
                                                     centers, center_only)]
                else:
                    outs = [reconstruct_beam_trajs(beam.ids, reg_out,
                                                   centers, center_only),
                            beam.logprobs]
                if need_prob and not greedy:
                    lg = beam.logits
                    outs.append(lg if fetch_dt is None else lg.to(fetch_dt))
                if device.type != "cuda":
                    return [o.numpy() for o in outs], None
                host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                        for o in outs]
                for dst, src in zip(host, outs):
                    dst.copy_(src, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
                return host, ready

    output_data: Dict[str, list] = {}
    beam_prob: Dict[str, tuple] = {}
    timed = timings is not None

    def resolve(batch_id, idxs, host, ready):
        with span("decode.fetch", batch_id, timed) as fetch:
            if ready is not None:
                ready.synchronize()
                # copy out of page-locked memory: the pickles keep views
                # of these arrays for the whole run
                host = [t.numpy().copy() for t in host]
        with span("decode.pack", batch_id, timed) as pack:
            trajs = host[0]
            logits = None
            if need_prob and not greedy:
                logprobs, logits = host[1], np.asarray(host[2], np.float32)
            for a, n in enumerate(idxs):
                traj_id = inputs.traj_ids[n]
                pred_len = min(int(inputs.pred_lengths[n]), T)
                if greedy:
                    output_data[traj_id] = [list(trajs[a, :pred_len])
                                            for _ in range(K)]
                else:
                    output_data[traj_id] = [list(trajs[a, j, :pred_len])
                                            for j in range(K)]
                if logits is not None:
                    beam_prob[traj_id] = (logits[a:a + 1, :, :pred_len],
                                          logprobs[a:a + 1])
        if timed:
            timings["fetch_s"] += fetch.seconds
            timings["fetch_bytes"] += sum(a.nbytes for a in host)
            timings["pack_s"] += pack.seconds
            timings["batches"] += 1

    def wait(batch_id, future):
        with span("decode.wait", batch_id):
            future.result()

    pending: list = []      # (batch id, its resolver's future)
    with ThreadPoolExecutor(max_workers=1) as pool:
        for lo in range(0, N, batch_size):
            with span("decode.batch", timed=timed) as b:
                idxs = np.arange(lo, min(lo + batch_size, N))
                pad = batch_size - len(idxs)
                padded = np.concatenate([idxs, np.full(pad, idxs[-1])]) \
                    if pad else idxs
                with span("decode.make_batch"):
                    batch = make_batch(inputs, padded, cfg)
                host, ready = dispatch(batch)
                pending.append((b.batch, pool.submit(resolve, b.batch, idxs,
                                                     host, ready)))
            if timed:
                timings["build_s"] += b.seconds
            if len(pending) >= 2:
                wait(*pending.pop(0))
        for p in pending:
            wait(*p)
    return output_data, beam_prob


def save_outputs(
    output_data: Dict[str, list],
    beam_prob: Dict[str, tuple],
    output_file: str,
    save_prob_file: Optional[str] = None,
) -> None:
    """Write the ``.traj.p`` pickle and, if asked, the ``.prob.p`` one."""
    if save_prob_file is not None and not beam_prob:
        raise ValueError(
            "save_prob_file requested but beam_prob is empty — the "
            ".prob.p contract needs beam search (not greedy) and "
            "need_prob=True")
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "wb") as f:
        pickle.dump(output_data, f)
    if save_prob_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(save_prob_file)),
                    exist_ok=True)
        with open(save_prob_file, "wb") as f:
            pickle.dump(beam_prob, f)
