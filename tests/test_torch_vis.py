"""The port's drawing primitives (``multiverse_torch/vis/trajs.py``)
against the JAX package's on the CPU: the same seeded numpy inputs at
128x72 go through each function of both, and the arrays that come out
must be equal (``np.array_equal``, tolerance 0). Both are numpy, cv2
and scipy code, so they run in one process with the same cv2."""

import itertools

import numpy as np
import pytest

from multiverse_tpu import vis as jax_vis_pkg
from multiverse_tpu.vis import trajs as jax_trajs
from multiverse_torch import vis as vis_pkg
from multiverse_torch.vis import trajs

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy")

H, W = 72, 128


def _frame(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (H, W, 3)).astype(np.uint8)


def _trajs(rng, n: int, t: int, outside: bool = False) -> list:
    """n float polylines of t points; ``outside`` lets points leave the
    frame on every side."""
    lo, hi = ((-20.0, -15.0), (W + 20.0, H + 15.0)) if outside else \
        ((2.0, 2.0), (W - 2.0, H - 2.0))
    return [rng.uniform(lo, hi, (t, 2)) for _ in range(n)]


def _gt(rng, futures: int = 3) -> dict:
    """A multi-future GT dict as the prepared pickles hold it: futures
    of different lengths, (frame, pid, x, y) rows, one without
    ``obs_traj``."""
    gt = {}
    for k in range(futures):
        n = 5 + 2 * k
        xy = rng.uniform((4.0, 4.0), (W - 4.0, H - 4.0), (n, 2))
        gt["f%d" % k] = {"x_agent_traj": [
            (i, 1.0, float(x), float(y)) for i, (x, y) in enumerate(xy)]}
        if k != 1:
            obs = rng.uniform((4.0, 4.0), (W - 4.0, H - 4.0), (4, 2))
            gt["f%d" % k]["obs_traj"] = [
                (i, 1.0, float(x), float(y)) for i, (x, y) in enumerate(obs)]
    return gt


def _centers(gh: int = 6, gw: int = 8) -> np.ndarray:
    """Grid-cell pixel centers of a [gh, gw] grid over the frame."""
    ys = (np.arange(gh) + 0.5) * H / gh
    xs = (np.arange(gw) + 0.5) * W / gw
    return np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)


def _plot_traj(m, thickness):
    rng = np.random.RandomState(1)
    frame = _frame(1)
    for traj in _trajs(rng, 3, 6, outside=True):
        frame = m.plot_traj(frame, traj, (10, 200, 30), thickness=thickness)
    return [frame]


def _rasterize(m, n_points):
    rng = np.random.RandomState(2)
    lines = _trajs(rng, 4, 7, outside=True) + [np.array([[5.0, 5.0]])]
    return [m.rasterize_polylines(lines, H, W, points_per_segment=n_points)]


def _heatmap(m, colormap):
    rng = np.random.RandomState(3)
    return [m.heatmap_overlay(_frame(3), _trajs(rng, 5, 6), colormap=colormap),
            m.heatmap_overlay(_frame(4), [], sigma=4.0)]


def _multifuture(m, flags):
    show_obs, use_heatmap, plot_points, show_less_gt = flags
    rng = np.random.RandomState(4)
    return [m.render_multifuture_frame(
        _frame(5), _gt(rng), _trajs(rng, 4, 9), show_obs=show_obs,
        use_heatmap=use_heatmap, plot_points=plot_points,
        show_less_gt=show_less_gt)]


def _draw_grid(m, grid):
    return [m.draw_grid(_frame(6), grid)]


def _prob_heatmap(m, clamped):
    rng = np.random.RandomState(5)
    centers = _centers()
    if clamped:
        # a calibration of another frame size: centers past the frame
        centers = centers * [1.6, 1.5]
    logits = rng.randn(len(centers))
    probs = np.exp(logits) / np.exp(logits).sum()
    return [m.grid_prob_heatmap(_frame(7), probs, centers),
            m.grid_prob_heatmap(_frame(8), probs, centers,
                                colormap=cv2.COLORMAP_AUTUMN, alpha=0.4),
            m.grid_prob_heatmap(_frame(9), np.zeros(len(centers)), centers)]


def _path_heatmap(m, clamped):
    rng = np.random.RandomState(6)
    centers = _centers()
    if clamped:
        centers = centers * [1.6, 1.5]
    ids = rng.randint(0, len(centers), (3, 7))
    frame = _frame(10)
    for beam, cmap in ((0, None), (1, cv2.COLORMAP_SPRING),
                       (2, cv2.COLORMAP_WINTER)):
        frame = m.grid_class_path_heatmap(frame, ids[beam], centers,
                                          "#%d" % beam, colormap=cmap)
    return [frame]


def _output_frame(m, flags):
    with_gt, use_heatmap = flags
    rng = np.random.RandomState(7)
    obs, gt, p1, p2 = _trajs(rng, 4, 6)
    return [m.render_output_frame(
        _frame(11), obs, gt if with_gt else None,
        [(p1, (255, 0, 0)), (p2, (0, 128, 255))], use_heatmap=use_heatmap)]


CASES = {}
for _t in (1, 2, 4):
    CASES["plot_traj-thickness%d" % _t] = (_plot_traj, _t)
for _n in (2, 40):
    CASES["rasterize_polylines-%dpoints" % _n] = (_rasterize, _n)
for _c, _name in ((None, "autumn"), (cv2.COLORMAP_JET, "jet")):
    CASES["heatmap_overlay-" + _name] = (_heatmap, _c)
for _flags in itertools.product((False, True), repeat=4):
    CASES["render_multifuture_frame-" + "".join(
        k if f else "-" for k, f in zip("ohpl", _flags))] = (
            _multifuture, _flags)
for _g in ((6, 8), (18, 32)):
    CASES["draw_grid-%dx%d" % _g] = (_draw_grid, _g)
for _clamped in (False, True):
    _s = "-clamped" if _clamped else ""
    CASES["grid_prob_heatmap" + _s] = (_prob_heatmap, _clamped)
    CASES["grid_class_path_heatmap" + _s] = (_path_heatmap, _clamped)
for _flags in itertools.product((False, True), repeat=2):
    CASES["render_output_frame-%s-%s" % (
        "gt" if _flags[0] else "nogt",
        "heat" if _flags[1] else "lines")] = (_output_frame, _flags)


@pytest.mark.parametrize("case", list(CASES))
def test_function_equals_jax(case):
    fn, arg = CASES[case]
    want = fn(jax_trajs, arg)
    got = fn(trajs, arg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w), case


def test_colors_and_exports_equal_jax():
    for name in ("OBS_COLOR", "GT_COLOR", "PRED_COLOR"):
        assert getattr(trajs, name) == getattr(jax_trajs, name)
    exported = sorted(n for n in vars(vis_pkg) if not n.startswith("_")
                      and n != "trajs")
    want = sorted(n for n in vars(jax_vis_pkg) if not n.startswith("_")
                  and n != "trajs")
    assert exported == want and len(exported) == 7


def test_frames_are_drawn_on():
    """The equality above is not that of two no-ops: each renderer
    changes the frame it is given."""
    rng = np.random.RandomState(8)
    frame = _frame(12)
    outs = [
        trajs.render_multifuture_frame(frame.copy(), _gt(rng),
                                       _trajs(rng, 3, 6), use_heatmap=True),
        trajs.render_output_frame(frame.copy(), *_trajs(rng, 2, 5),
                                  [(_trajs(rng, 1, 5)[0], (255, 0, 0))]),
        trajs.grid_prob_heatmap(frame.copy(), np.eye(48)[10], _centers()),
        trajs.draw_grid(frame.copy(), (6, 8)),
    ]
    for out in outs:
        assert out.shape == frame.shape and not np.array_equal(out, frame)
