"""Trajectory animation (the JAX package's ``analysis/animate.py``; the
reference's examples/visualize.py / scripts/paper_vis.py): per-player
closed-loop trajectories of an evaluation JSON dict (positions, goals,
optional masks highlighting the selected players), saved as a GIF (pillow)
or as an MP4 where ffmpeg is present. matplotlib is imported inside
``animate_result`` (see ``plots._pyplot``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .plots import _pyplot


def animate_result(
    result: Mapping,
    out_path: str,
    *,
    num_players: int,
    ego: int = 1,
    fps: int = 10,
    trail: int = 10,
    bounds: Optional[Sequence[float]] = None,  # (xmin, xmax, ymin, ymax)
    title: str = "",
) -> None:
    """Animate one evaluation JSON (Player i Trajectory / Goal / Mask keys)."""
    plt = _pyplot()
    import matplotlib.animation as animation

    trajs = [
        np.asarray(result[f"Player {i} Trajectory"])[:, :2]
        for i in range(1, num_players + 1)
    ]
    goals = [
        np.asarray(result.get(f"Player {i} Goal", [np.nan, np.nan]))
        for i in range(1, num_players + 1)
    ]
    masks = result.get("Player 1 Mask")
    T = min(len(t) for t in trajs)

    fig, ax = plt.subplots(figsize=(6, 6))
    if bounds is None:
        allp = np.concatenate(trajs)
        pad = 1.0
        bounds = (
            float(np.nanmin(allp[:, 0])) - pad,
            float(np.nanmax(allp[:, 0])) + pad,
            float(np.nanmin(allp[:, 1])) - pad,
            float(np.nanmax(allp[:, 1])) + pad,
        )
    ax.set_xlim(bounds[0], bounds[1])
    ax.set_ylim(bounds[2], bounds[3])
    ax.set_aspect("equal")
    ax.set_title(title)

    colors = plt.cm.tab10(np.linspace(0, 1, max(num_players, 2)))
    dots = []
    trails = []
    for i in range(num_players):
        (dot,) = ax.plot([], [], "o", color=colors[i], markersize=10 if i == ego - 1 else 7)
        (line,) = ax.plot([], [], "-", color=colors[i], alpha=0.5)
        ax.plot(*goals[i], "*", color=colors[i], markersize=12, alpha=0.6)
        dots.append(dot)
        trails.append(line)

    def frame(t):
        for i in range(num_players):
            p = trajs[i][t]
            dots[i].set_data([p[0]], [p[1]])
            lo = max(0, t - trail)
            trails[i].set_data(trajs[i][lo : t + 1, 0], trajs[i][lo : t + 1, 1])
            if masks is not None and i != ego - 1 and t < len(masks):
                selected = bool(np.asarray(masks[t])[i] >= 0.5)
                dots[i].set_alpha(1.0 if selected else 0.25)
        return dots + trails

    anim = animation.FuncAnimation(fig, frame, frames=T, blit=True)
    if out_path.endswith(".mp4"):
        try:
            anim.save(out_path, writer="ffmpeg", fps=fps)
        except Exception:
            out_path = out_path[:-4] + ".gif"
            anim.save(out_path, writer="pillow", fps=fps)
    else:
        anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
