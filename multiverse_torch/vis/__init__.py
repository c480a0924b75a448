"""The port's trajectory drawing (``multiverse_torch/vis/trajs.py``)."""

from multiverse_torch.vis.trajs import (  # noqa: F401
    draw_grid,
    grid_prob_heatmap,
    heatmap_overlay,
    plot_traj,
    rasterize_polylines,
    render_multifuture_frame,
    render_output_frame,
)
