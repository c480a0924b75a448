"""Dynamic-batching prediction engine over the decode path (PyTorch).

The port's own ``ServingEngine`` (of ``multiverse_tpu/serving/engine.py``),
with the same host design and a torch device step:

* **fixed batch shape.** Every request batch is padded to ``max_batch``
  (pad rows repeat the last real request), so every batch costs the
  same device time and occupancy is throughput;
* **dynamic batching.** Requests queue; a batcher thread drains up to
  ``max_batch`` of them, waiting at most ``max_delay_ms`` after the
  first while a device slot is free, and keeps filling while both
  slots are in flight. A bounded queue (``max_queue``) rejects with
  :class:`EngineOverloadedError` instead of admitting work that could
  only wait;
* **two stages.** The batcher uploads raw [B, T_obs, 2] points from
  pinned host memory, enqueues ``beam_forward`` or ``greedy_forward``
  (grid rasterisation and trajectory reconstruction included) and the
  copy of the [B, K, T, 2] points back into pinned memory, and records
  a CUDA event; the resolver waits on that event and wakes the waiters.
  PyTorch enqueues CUDA work without waiting for it, so the next batch
  is assembled while the previous one decodes;
* **device-resident weights.** Uploaded once; ``update_params`` swaps
  them between batches;
* **data-parallel across devices** (``mesh``, the JAX engine's): one
  process a device (``multiverse_torch/parallel``), every rank builds
  the engine. Rank 0 runs the front ends, the batcher and the resolver
  and broadcasts each device batch; every rank rasterises and decodes
  its block of ``max_batch / world`` rows with its tier's kernel, and
  the results come back to rank 0 in rank order. The other ranks run
  :meth:`ServingEngine.run_worker` until rank 0 closes. Weight updates
  reach every rank between device batches, never inside one.

On ``device="cpu"`` the same engine runs the plain PyTorch path (the
tests use it).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from multiverse_torch.bridge import check_params, prune_to_template
from multiverse_torch.config import MultiverseConfig
from multiverse_torch.geometry import grid_centers, xy_to_cell
from multiverse_torch.inference import (
    _resolve_device,
    beam_forward,
    greedy_forward,
    reconstruct_beam_trajs,
    reconstruct_greedy_trajs,
)
from multiverse_torch.models.multiverse import Batch
from multiverse_torch.parallel.mesh import (
    Mesh,
    broadcast_params,
    gather_rows,
    replicate,
)

# the commands rank 0 broadcasts to the other ranks of a mesh engine
_CMD_STOP, _CMD_BATCH, _CMD_PARAMS, _CMD_NOOP = range(4)
# an idle mesh engine's rank 0 sends a no-op this often, so the other
# ranks' wait for the next command never reaches the group's timeout
_HEARTBEAT_S = 5.0


@dataclass
class PredictionResult:
    """K predicted futures for one request.

    trajs: [K, T, 2] absolute pixel coordinates (center + offset).
    logprobs: [K] total beam log-likelihoods (greedy: zeros).
    """

    trajs: np.ndarray
    logprobs: np.ndarray
    pred_len: int


class EngineOverloadedError(RuntimeError):
    """Raised by submit/predict when the bounded request queue is full.

    Backpressure signal for front ends (HTTP maps it to 503 +
    Retry-After). The bound is on the QUEUE: the total admitted backlog
    can reach ``max_queue`` queued plus up to ``max_batch`` in the batch
    the batcher is forming while it waits for a device slot, plus the
    in-flight batches.
    """


class RawInputs(NamedTuple):
    """One batch as uploaded: raw pixel trajectories (rasterised on the
    device by :func:`rasterize_batch`)."""

    obs_xy: object       # [B, T_obs, 2] float32
    obs_scene: object    # [B, T_obs] int32 rows into scene_feat
    scene_feat: object   # [F, SH, SW, C] uint8
    pred_length: object  # [B] int32


def rasterize_batch(raw: RawInputs, cfg: MultiverseConfig,
                    centers_hw: torch.Tensor) -> Batch:
    """The device Batch of raw inputs (tensors on one device): cell ids
    of every grid scale and the dense regression targets of the active
    one, in f32 as the JAX engine's step computes them."""
    cls = torch.stack(
        [xy_to_cell(raw.obs_xy, cfg.video_h, cfg.video_w, gh, gw)
         for (gh, gw) in cfg.scene_grids], dim=1)         # [B, S, T]
    tgt0 = raw.obs_xy[:, :, None, None, :] - centers_hw[None, None]
    return Batch(obs_grid_class=cls, obs_grid_target_all=(tgt0,),
                 obs_scene=raw.obs_scene, scene_feat=raw.scene_feat,
                 pred_length=raw.pred_length)


class _Pending:
    __slots__ = ("obs_traj", "scene_onehot", "pred_len", "event",
                 "result", "error", "t_submit", "on_done", "abandoned")

    def __init__(self, obs_traj, scene_onehot, pred_len, on_done=None):
        self.obs_traj = obs_traj
        self.scene_onehot = scene_onehot  # [T_obs, SH, SW, C] uint8
        self.pred_len = pred_len
        self.event = threading.Event()
        self.result: Optional[PredictionResult] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.perf_counter()
        # completion hook for event-loop front ends: called (from an
        # engine thread) right after `event` is set, exactly once
        self.on_done = on_done
        # set by a waiter that gave up (predict timeout): the batcher
        # drops abandoned requests instead of spending device rows on
        # clients that are gone
        self.abandoned = False

    def _finish(self):
        self.event.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception:
                # a front-end hook failure (e.g. its event loop already
                # closed mid-shutdown) must not propagate into the
                # engine thread delivering the rest of the batch
                pass


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    rejected: int = 0
    abandoned: int = 0
    largest_batch: int = 0    # the most real requests in one batch
    latency_sum_s: float = 0.0
    latency_max_s: float = 0.0
    # recent completion latencies for the percentile fields; bounded so
    # a long-lived server's stats stay O(1) memory
    _recent: "deque" = field(
        default_factory=lambda: deque(maxlen=4096), repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def record_batch(self, n_real: int, latencies: List[float]):
        with self._lock:
            self.batches += 1
            self.requests += n_real
            self.largest_batch = max(self.largest_batch, n_real)
            for v in latencies:
                self.latency_sum_s += v
                self.latency_max_s = max(self.latency_max_s, v)
            self._recent.extend(latencies)

    def reset(self):
        with self._lock:
            self.requests = self.batches = self.errors = 0
            self.rejected = self.abandoned = self.largest_batch = 0
            self.latency_sum_s = self.latency_max_s = 0.0
            self._recent.clear()

    def snapshot(self) -> dict:
        with self._lock:
            mean_lat = (self.latency_sum_s / self.requests
                        if self.requests else 0.0)
            occ = (self.requests / self.batches
                   if self.batches else 0.0)
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "errors": self.errors,
                "rejected": self.rejected,
                "abandoned": self.abandoned,
                "mean_batch_occupancy": round(occ, 2),
                "largest_batch": self.largest_batch,
                "mean_latency_ms": round(mean_lat * 1e3, 2),
                "max_latency_ms": round(self.latency_max_s * 1e3, 2),
            }
            if self._recent:
                lat = np.sort(np.asarray(self._recent))
                for q, name in ((0.50, "p50"), (0.99, "p99")):
                    idx = min(len(lat) - 1, int(q * len(lat)))
                    out[f"{name}_latency_ms"] = round(
                        float(lat[idx]) * 1e3, 2)
            return out


class ServingEngine:
    """Dynamic-batching prediction engine.

    Args:
        params: a :class:`~multiverse_torch.models.Multiverse` (moved to
            ``device``).
        cfg: model configuration; ``use_beam_search`` selects diverse
            beam (K futures) vs greedy (1 future replicated K times,
            the offline driver's contract).
        max_batch: the fixed batch size (the throughput knob).
        max_delay_ms: how long the batcher waits to fill a batch after
            the first request arrives (the latency knob).
        T_pred: decode length; per-request ``pred_len`` <= T_pred is
            sliced on the way out.
        inflight_slots: device batches in flight (computing + queued).
        max_queue: bound on the request QUEUE (None = unbounded; must be
            >= 1 otherwise); when full, ``submit`` raises
            :class:`EngineOverloadedError`.
        device: where the step runs, ``cuda`` by default; ``cpu`` runs
            the plain PyTorch path.
        mesh: a :class:`~multiverse_torch.parallel.Mesh` joined by
            :func:`~multiverse_torch.parallel.launch` (every rank builds
            the engine with the same arguments): each batch is sharded
            over its ranks, ``device`` is then the rank's; ``max_batch``
            must be divisible by its world size. On ranks other than 0
            call :meth:`run_worker`.
    """

    def __init__(
        self,
        params,
        cfg: MultiverseConfig,
        max_batch: int = 16,
        max_delay_ms: float = 5.0,
        T_pred: Optional[int] = None,
        inflight_slots: int = 2,
        max_queue: Optional[int] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        if max_queue is not None and max_queue < 1:
            # Queue(maxsize=0) means UNBOUNDED in python, the opposite
            # of the strictest admission a 0 would be asking for
            raise ValueError("max_queue must be >= 1 (or None for "
                             "unbounded)")
        self._mesh = mesh
        self.device = _resolve_device(device if mesh is None
                                      else mesh.device)
        self.cfg = cfg.validate()
        self.max_batch = int(max_batch)
        if mesh is not None and mesh.model_parallel != 1:
            raise ValueError("a serving mesh is data-parallel: "
                             "model_parallel must be 1")
        if mesh is not None and self.max_batch % mesh.world != 0:
            raise ValueError(
                f"max_batch {self.max_batch} not divisible by the mesh "
                f"data axis ({mesh.world})")
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.T_pred = int(T_pred or cfg.pred_len)
        self.greedy = not cfg.use_beam_search
        i = cfg.active_scales[0]
        h, w = cfg.scene_grids[i]
        centers = grid_centers(cfg.video_h, cfg.video_w, h, w)
        self._centers = torch.as_tensor(
            centers.reshape(-1, 2), dtype=torch.float32, device=self.device)
        self._centers_hw = torch.as_tensor(
            centers, dtype=torch.float32, device=self.device)
        # fixed scene-table height: every obs frame of every slot
        # distinct is the worst case
        self.F_scene = self.max_batch * cfg.obs_len
        self._params = (params.to(self.device) if mesh is None
                        else replicate(mesh, params))
        self._next_params = None      # a mesh engine's pending update
        self._next_lock = threading.Lock()
        self._last_collective = time.perf_counter()

        # device-resident all-background scene table for the common case
        # where no request attaches a scene; the host copy is the
        # template of the batches that do
        rows = np.zeros(
            (self.F_scene, cfg.scene_h, cfg.scene_w, cfg.scene_class),
            np.uint8)
        rows[..., 0] = 1
        self._host_scene_template = rows
        self._default_scene = torch.from_numpy(rows).to(self.device)

        self._queue: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=0 if max_queue is None else max_queue)
        self._stop = threading.Event()
        self.stats = EngineStats()
        # two-stage pipeline: the batcher drains, builds and enqueues a
        # device batch, the resolver waits for its results and wakes
        # the waiters. _slots bounds the in-flight device batches: a
        # slot is taken at dispatch and released only after the batch
        # resolves, and while no slot is free the batcher keeps filling
        # the next batch instead of locking in a small one
        self._inflight: "queue.Queue" = queue.Queue()
        self._slots = threading.BoundedSemaphore(max(1, inflight_slots))
        if mesh is not None and not mesh.is_main:
            return      # a worker rank: run_worker() serves rank 0
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="mvt-serving-batcher",
            daemon=True)
        self._resolver = threading.Thread(
            target=self._resolver_loop, name="mvt-serving-resolver",
            daemon=True)
        self._batcher.start()
        self._resolver.start()

    # ------------------------------------------------------------ API

    def warmup(self) -> float:
        """Run the step once (kernel build, CUDA and cuDNN set-up);
        returns seconds spent. Call before accepting traffic."""
        t0 = time.perf_counter()
        obs = np.tile(
            np.asarray([[self.cfg.video_w / 2.0,
                         self.cfg.video_h / 2.0]], np.float32),
            (self.cfg.obs_len, 1))
        self.predict(obs, timeout=None)
        self.stats.reset()   # set-up time is not traffic latency
        return time.perf_counter() - t0

    def update_params(self, params) -> None:
        """Swap the served weights without dropping traffic. The new
        module (or nested mapping of arrays) is pruned to the served
        model's names (a checkpoint with more grid scales loads, as in
        the JAX package's restore), moved to the device and the
        reference swapped between batch dispatches; batches already
        dispatched finish on the weights they started with."""
        try:
            params = prune_to_template(params, self._params)
            check_params(params, self._params)
        except (KeyError, ValueError) as exc:
            raise ValueError(
                "update_params: the new weights do not match the served "
                "model (a different architecture needs a new engine): "
                f"{exc}") from None
        if self._mesh is None:
            self._params = params.to(self.device)
        else:
            # the batcher broadcasts it to every rank before its next
            # device batch, the only thread that talks to the ranks
            with self._next_lock:
                self._next_params = params.to(self.device)

    def submit(
        self,
        obs_traj: np.ndarray,
        scene_class_map: Optional[np.ndarray] = None,
        pred_len: Optional[int] = None,
        on_done=None,
    ) -> _Pending:
        """Enqueue one request; returns a waitable handle.

        ``on_done(pending)`` is an optional completion hook invoked from
        an engine thread right after the handle's event is set.

        Args:
            obs_traj: [obs_len, 2] pixel trajectory.
            scene_class_map: optional [SH, SW] or [T_obs, SH, SW]
                semantic class-id map (in the model's class space);
                None = all background.
            pred_len: decode steps to return (<= engine T_pred).
        """
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        cfg = self.cfg
        # a copy: the batcher reads it later on its own thread, and a
        # client reusing its buffer must not change an in-flight batch
        obs = np.array(obs_traj, np.float32)
        if obs.shape != (cfg.obs_len, 2):
            raise ValueError(
                f"obs_traj must be [{cfg.obs_len}, 2], got {obs.shape}")
        if not np.isfinite(obs).all():
            raise ValueError("obs_traj contains non-finite values")
        pl = self.T_pred if pred_len is None else int(pred_len)
        if not 1 <= pl <= self.T_pred:
            raise ValueError(
                f"pred_len {pl} outside [1, {self.T_pred}]")
        onehot = self._scene_onehot(scene_class_map)
        pending = _Pending(obs, onehot, pl, on_done=on_done)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            with self.stats._lock:
                self.stats.rejected += 1
            raise EngineOverloadedError(
                f"request queue full ({self._queue.maxsize} waiting); "
                f"retry after the current batches drain")
        if self._stop.is_set():
            # close() may already have swept the queue: fail what is left
            while True:
                try:
                    p = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._fail([p], RuntimeError("engine is closed"))
        return pending

    def predict(
        self,
        obs_traj: np.ndarray,
        scene_class_map: Optional[np.ndarray] = None,
        pred_len: Optional[int] = None,
        timeout: Optional[float] = 30.0,
    ) -> PredictionResult:
        """Blocking submit + wait."""
        pending = self.submit(obs_traj, scene_class_map, pred_len)
        if not pending.event.wait(timeout):
            # nobody will read the result: let the batcher drop it
            pending.abandoned = True
            raise TimeoutError("prediction timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def run_worker(self) -> None:
        """A mesh engine's rank other than 0: decode this rank's block of
        every device batch rank 0 broadcasts, and take its weight
        updates, until rank 0 closes its engine."""
        mesh = self._mesh
        if mesh is None or mesh.is_main:
            raise RuntimeError("run_worker is for a mesh engine's ranks "
                               "other than 0")
        while True:
            cmd, has_scene = self._recv_header()
            if cmd == _CMD_STOP:
                return
            if cmd == _CMD_PARAMS:
                # this rank decodes nothing in between: in place is safe
                broadcast_params(mesh, self._params)
            elif cmd == _CMD_BATCH:
                try:
                    with torch.inference_mode():
                        self._mesh_decode(self._params,
                                          self._recv_batch(has_scene))
                except Exception:   # noqa: BLE001 (rank 0 fails the batch)
                    continue

    def close(self, batcher_timeout_s: float = 5.0,
              resolver_timeout_s: float = 30.0):
        self._stop.set()
        self._batcher.join(timeout=batcher_timeout_s)
        self._resolver.join(timeout=resolver_timeout_s)
        # fail anything still queued and, if the resolver is stuck,
        # anything still in flight, so waiters do not block out their
        # full predict timeout
        while True:
            try:
                pending = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail([pending], RuntimeError("engine closed"))
        if not self._resolver.is_alive():
            return  # clean exit: the resolver drained _inflight itself
        while True:
            try:
                reqs, _ = self._inflight.get_nowait()
            except queue.Empty:
                break
            self._fail(reqs, RuntimeError("engine closed"))

    # ------------------------------------------------------- internals

    def _scene_onehot(self, class_map) -> Optional[np.ndarray]:
        """One-hot scene mask for a request; None = all background
        (lets the batch builder keep the cached device table)."""
        cfg = self.cfg
        C = cfg.scene_class
        if class_map is None:
            return None
        cm = np.asarray(class_map)
        if cm.ndim == 2:
            cm = np.broadcast_to(cm, (cfg.obs_len,) + cm.shape)
        if cm.shape != (cfg.obs_len, cfg.scene_h, cfg.scene_w):
            raise ValueError(
                f"scene_class_map must be [{cfg.scene_h}, "
                f"{cfg.scene_w}] or [{cfg.obs_len}, {cfg.scene_h}, "
                f"{cfg.scene_w}], got {np.asarray(class_map).shape}")
        ids = cm.astype(np.int64)
        if ids.min() < 0 or ids.max() >= C:
            # ids outside the model's class space mean the client is in
            # a different labeling: reject instead of silently
            # conditioning on a clipped scene
            raise ValueError(
                f"scene class ids must be in [0, {C - 1}], got "
                f"[{ids.min()}, {ids.max()}]")
        return (ids[..., None]
                == np.arange(C, dtype=np.int64)).astype(np.uint8)

    def _drain(self) -> List[_Pending]:
        """Block for the first request, then fill up to max_batch.

        The delay dial only gates dispatch while a device slot is free:
        with both slots in flight, dispatching earlier could not start
        the batch sooner, so the batcher keeps collecting. Returns with
        a slot HELD (unless empty or stopping)."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        have_slot = self._slots.acquire(blocking=False)
        while len(batch) < self.max_batch and not self._stop.is_set():
            if not have_slot:
                # sweep whatever is queued, then block on the semaphore
                # (woken the instant the resolver releases a slot)
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                if len(batch) >= self.max_batch:
                    break
                have_slot = self._slots.acquire(timeout=0.05)
                continue
            now = time.perf_counter()
            if now >= deadline:
                # sweep anything already queued, then dispatch
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                break
            try:
                batch.append(self._queue.get(
                    timeout=max(deadline - now, 0.0005)))
            except queue.Empty:
                continue
        while not have_slot and not self._stop.is_set():
            have_slot = self._slots.acquire(timeout=0.1)
        if not have_slot:  # stopping
            self._fail(batch, RuntimeError("engine closed"))
            return []
        return batch

    def _build_batch(self, reqs: List[_Pending]) -> RawInputs:
        """The padded host payload: raw trajectories (rasterised on the
        device). Pad slots repeat the last real request."""
        cfg = self.cfg
        B, T_obs = self.max_batch, cfg.obs_len
        R = len(reqs)

        obs_xy = np.empty((B, T_obs, 2), np.float32)
        obs_xy[:R] = [r.obs_traj for r in reqs]
        obs_xy[R:] = obs_xy[R - 1]
        obs_scene = np.arange(B * T_obs, dtype=np.int32).reshape(B, T_obs)
        pred_lens = np.empty((B,), np.int32)
        pred_lens[:R] = [r.pred_len for r in reqs]
        pred_lens[R:] = reqs[-1].pred_len

        if all(r.scene_onehot is None for r in reqs):
            scene_rows = None       # the device-resident background table
        else:
            scene_rows = self._host_scene_template.copy()
            for a, r in enumerate(reqs):
                if r.scene_onehot is not None:
                    scene_rows[a * T_obs:(a + 1) * T_obs] = r.scene_onehot
            if reqs[-1].scene_onehot is not None:
                # pad slots repeat the last real request's scene too
                last = scene_rows[(R - 1) * T_obs:R * T_obs]
                for a in range(R, B):
                    scene_rows[a * T_obs:(a + 1) * T_obs] = last
        return RawInputs(obs_xy=obs_xy, obs_scene=obs_scene,
                         scene_feat=scene_rows, pred_length=pred_lens)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _decode(self, params, up: RawInputs) -> List[torch.Tensor]:
        """Rasterise and decode device inputs: [trajs] for greedy,
        [trajs, logprobs] for beam."""
        batch = rasterize_batch(up, self.cfg, self._centers_hw)
        if self.greedy:
            logits, reg_out = greedy_forward(params, batch, self.cfg,
                                             T_pred=self.T_pred)
            return [reconstruct_greedy_trajs(logits, reg_out,
                                             self._centers)]
        beam, reg_out = beam_forward(params, batch, self.cfg,
                                     T_pred=self.T_pred)
        return [reconstruct_beam_trajs(beam.ids, reg_out, self._centers),
                beam.logprobs]

    # ---------------------------------------------- mesh (rank to rank)

    def _send_header(self, cmd: int, has_scene: bool = False) -> None:
        self._mesh.broadcast(torch.tensor(
            [cmd, int(has_scene)], dtype=torch.int64, device=self.device))
        self._last_collective = time.perf_counter()

    def _recv_header(self):
        hdr = self._mesh.broadcast(torch.zeros(
            2, dtype=torch.int64, device=self.device)).tolist()
        return hdr[0], bool(hdr[1])

    def _send_params(self) -> None:
        """Rank 0: the pending weights to every rank, then served (the
        batches in flight finish on the module they started with)."""
        with self._next_lock:
            params, self._next_params = self._next_params, None
        self._send_header(_CMD_PARAMS)
        broadcast_params(self._mesh, params)
        self._params = params

    def _pack(self, up: RawInputs) -> torch.Tensor:
        """[B, 3 T_obs + 1] f32: points, scene rows and pred lengths
        (integers below 2^24, exact in f32), one broadcast."""
        return torch.cat([up.obs_xy.reshape(self.max_batch, -1),
                          up.obs_scene.float(),
                          up.pred_length.float()[:, None]], dim=1)

    def _recv_batch(self, has_scene: bool) -> RawInputs:
        T = self.cfg.obs_len
        packed = self._mesh.broadcast(torch.empty(
            (self.max_batch, 3 * T + 1), dtype=torch.float32,
            device=self.device))
        scene = self._default_scene
        if has_scene:
            scene = self._mesh.broadcast(torch.empty_like(scene))
        return RawInputs(
            obs_xy=packed[:, :2 * T].reshape(self.max_batch, T, 2),
            obs_scene=packed[:, 2 * T:3 * T].int(), scene_feat=scene,
            pred_length=packed[:, 3 * T].int())

    def _mesh_decode(self, params, up: RawInputs) -> List[torch.Tensor]:
        """Every rank: decode this rank's block of the batch, then every
        rank's outputs in rank order (rank 0 reads them) and, last, the
        count of ranks whose decode raised. Such a rank still takes part
        in the gathers, so no rank is left waiting; rank 0 fails the
        batch when it reads a count above 0 (:meth:`_resolve`)."""
        mesh = self._mesh
        b = self.max_batch // mesh.world
        lo, hi = mesh.rank * b, (mesh.rank + 1) * b
        local = RawInputs(obs_xy=up.obs_xy[lo:hi],
                          obs_scene=up.obs_scene[lo:hi],
                          scene_feat=up.scene_feat,
                          pred_length=up.pred_length[lo:hi])
        failed = torch.zeros(1, dtype=torch.float32, device=self.device)
        error = None
        try:
            outs = self._decode(params, local)
        except Exception as exc:   # noqa: BLE001 (re-raised below)
            error = exc
            failed.fill_(1.0)
            K, T = self.cfg.beam_size, self.T_pred
            outs = [torch.zeros((b, T, 2) if self.greedy else (b, K, T, 2),
                                device=self.device)]
            if not self.greedy:
                outs.append(torch.zeros((b, K), device=self.device))
        outs = [gather_rows(mesh, o) for o in outs]
        mesh.all_reduce_sum(failed)
        if error is not None:
            if not mesh.is_main:
                traceback.print_exception(error)
            raise error
        return outs + [failed]

    def _heartbeat(self) -> None:
        """Rank 0, idle: a no-op now and then keeps the other ranks'
        wait inside the group's timeout."""
        if self._mesh is not None and self._mesh.world > 1 and \
                time.perf_counter() - self._last_collective > _HEARTBEAT_S:
            self._send_header(_CMD_NOOP)

    def _device_step(self, params, raw: RawInputs):
        """Enqueue one batch on the device (on a mesh: on every rank).
        Returns (host arrays, CUDA event that marks them ready, or None
        on the CPU)."""
        dev = self.device
        scene = (self._default_scene if raw.scene_feat is None
                 else self._upload(raw.scene_feat))
        up = RawInputs(obs_xy=self._upload(raw.obs_xy),
                       obs_scene=self._upload(raw.obs_scene),
                       scene_feat=scene,
                       pred_length=self._upload(raw.pred_length))
        with torch.inference_mode():
            if self._mesh is None:
                outs = self._decode(params, up)
            else:
                self._send_header(_CMD_BATCH, raw.scene_feat is not None)
                self._mesh.broadcast(self._pack(up))
                if raw.scene_feat is not None:
                    self._mesh.broadcast(scene)
                outs = self._mesh_decode(params, up)
            if dev.type != "cuda":
                return [o.numpy() for o in outs], None
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outs]
            for dst, src in zip(host, outs):
                dst.copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            return host, ready

    def _batcher_loop(self):
        """Stage 1: drain requests, build and enqueue a device batch. On
        a mesh it is rank 0's one thread that talks to the other ranks,
        and it sends them the stop when it ends."""
        try:
            self._batch_until_stopped()
        finally:
            if self._mesh is not None:
                self._send_header(_CMD_STOP)

    def _batch_until_stopped(self):
        while not self._stop.is_set():
            reqs = self._drain()  # holds one in-flight slot on success
            if not reqs:
                self._heartbeat()
                continue
            # drop requests whose waiter already timed out and left
            live = [r for r in reqs if not r.abandoned]
            if len(live) != len(reqs):
                with self.stats._lock:
                    self.stats.abandoned += len(reqs) - len(live)
            if not live:
                self._slots.release()
                continue
            reqs = live
            if self._next_params is not None:
                self._send_params()
            try:
                out = self._device_step(self._params,
                                        self._build_batch(reqs))
            except Exception as exc:  # resolve waiters, keep serving
                self._slots.release()
                self._fail(reqs, exc)
                continue
            self._inflight.put((reqs, out))

    def _resolver_loop(self):
        """Stage 2: wait for device results, wake waiters."""
        K = self.cfg.beam_size
        # keep serving while the batcher lives: it may still be inside
        # a long first step (kernel build) and enqueue afterwards
        while not (self._stop.is_set() and self._inflight.empty()
                   and not self._batcher.is_alive()):
            try:
                reqs, out = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._resolve(reqs, out, K)
            except Exception as exc:
                self._fail(reqs, exc)
            finally:
                self._slots.release()  # batch fully landed: free a slot

    def _resolve(self, reqs: List[_Pending], out, K: int):
        host, ready = out
        if ready is not None:
            ready.synchronize()
            # copy out of page-locked memory the allocator will reuse
            host = [t.numpy().copy() for t in host]
        if self._mesh is not None and host[-1][0] > 0:
            raise RuntimeError("%d rank(s) of the mesh failed to decode "
                               "their block of the batch" % host[-1][0])
        trajs_all = host[0]            # [B, T, 2] greedy, [B, K, T, 2] beam
        now = time.perf_counter()
        lats = []
        for a, r in enumerate(reqs):
            pl = r.pred_len
            if self.greedy:
                trajs = np.tile(trajs_all[a, :pl][None], (K, 1, 1))
                logprobs = np.zeros((K,), np.float32)
            else:
                trajs = trajs_all[a, :, :pl]
                logprobs = host[1][a]
            r.result = PredictionResult(
                trajs=np.ascontiguousarray(trajs, np.float32),
                logprobs=logprobs, pred_len=pl)
            lats.append(now - r.t_submit)
            r._finish()
        self.stats.record_batch(len(reqs), lats)

    def _fail(self, reqs: List[_Pending], exc: Exception):
        # skip requests already resolved: _resolve may have woken part
        # of a batch before the failure
        failed = [r for r in reqs if not r.event.is_set()]
        with self.stats._lock:
            self.stats.errors += len(failed)
        for r in failed:
            r.error = exc
            r._finish()
