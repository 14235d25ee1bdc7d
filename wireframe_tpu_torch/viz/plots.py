"""Matplotlib 3D visualization of clouds, wireframes, and predictions.

The port's copy of `wireframe_tpu/viz/plots.py`, with the same
functions, signatures, titles and artists.  Capability parity with the
reference's visualize/visualize_wireframe.py:26-253: point cloud
scatter, wireframe rendering, GT-vs-prediction 3-panel comparison,
training-loss curve, and edge-probability histograms.  All functions
return the Figure and optionally save a PNG; nothing here touches the
model (the comparison consumes already-decoded predictions).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import matplotlib
import numpy as np

# Default to the headless Agg backend, but don't stomp on a backend the
# host program (e.g. a notebook) already initialized.
if "matplotlib.pyplot" not in sys.modules:
    matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d import Axes3D  # noqa: F401,E402


def _maybe_save(fig, save_path: Optional[str]):
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_point_cloud(points: np.ndarray, title: str = "Point Cloud",
                     save_path: Optional[str] = None,
                     max_points: int = 5000):
    """Scatter an (N, >=3) cloud; subsamples above max_points for speed."""
    points = np.asarray(points)
    if len(points) > max_points:
        idx = np.random.default_rng(0).choice(
            len(points), max_points, replace=False)
        points = points[idx]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2],
               s=1, c=points[:, 2], cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    return _maybe_save(fig, save_path)


def _draw_wireframe(ax, vertices: np.ndarray, edges: np.ndarray,
                    color: str, label: str):
    vertices = np.asarray(vertices)
    if len(vertices):
        ax.scatter(vertices[:, 0], vertices[:, 1], vertices[:, 2],
                   c=color, s=30, label=label)
    for e in np.asarray(edges).reshape(-1, 2):
        seg = vertices[list(e)]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=color, linewidth=1.2)


def plot_wireframe(vertices: np.ndarray, edges: np.ndarray,
                   title: str = "Wireframe", color: str = "tab:blue",
                   save_path: Optional[str] = None):
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    _draw_wireframe(ax, vertices, edges, color, "vertices")
    ax.set_title(title)
    ax.legend()
    return _maybe_save(fig, save_path)


def plot_prediction_comparison(point_cloud: np.ndarray,
                               gt_vertices: np.ndarray,
                               gt_edges: np.ndarray,
                               pred_vertices: np.ndarray,
                               pred_edges: np.ndarray,
                               metrics: Optional[Dict[str, float]] = None,
                               save_path: Optional[str] = None):
    """3-panel figure: input cloud | ground truth | prediction
    (visualize_wireframe.py:77-204 shape, minus the in-plot model run)."""
    fig = plt.figure(figsize=(18, 6))

    ax = fig.add_subplot(131, projection="3d")
    pc = np.asarray(point_cloud)
    if len(pc) > 4000:
        pc = pc[np.random.default_rng(0).choice(len(pc), 4000, replace=False)]
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=1, c=pc[:, 2], cmap="viridis")
    ax.set_title("Input point cloud")

    ax = fig.add_subplot(132, projection="3d")
    _draw_wireframe(ax, gt_vertices, gt_edges, "tab:green", "GT")
    ax.set_title(f"Ground truth ({len(gt_vertices)}V / {len(gt_edges)}E)")

    ax = fig.add_subplot(133, projection="3d")
    _draw_wireframe(ax, pred_vertices, pred_edges, "tab:red", "pred")
    title = f"Prediction ({len(pred_vertices)}V / {len(pred_edges)}E)"
    if metrics:
        title += (f"\nC-F1 {metrics.get('corners_f1', 0):.3f}  "
                  f"E-F1 {metrics.get('edges_f1', 0):.3f}  "
                  f"ACO {metrics.get('average_corner_offset', 0):.3f}")
    ax.set_title(title)
    return _maybe_save(fig, save_path)


def plot_training_loss(history: Sequence[Dict[str, float]],
                       save_path: Optional[str] = None):
    """Loss curves from MetricWriter history / train_metrics.jsonl rows."""
    fig, ax = plt.subplots(figsize=(9, 5))
    epochs = [h["epoch"] for h in history]
    for key in ("total_loss", "vertex_loss", "existence_loss", "edge_loss"):
        if history and key in history[0]:
            ax.plot(epochs, [h[key] for h in history], label=key)
    ax.set_xlabel("epoch"); ax.set_ylabel("loss"); ax.set_yscale("log")
    ax.legend(); ax.grid(alpha=0.3)
    ax.set_title("Training loss")
    return _maybe_save(fig, save_path)


def plot_edge_probabilities(edge_probs: np.ndarray,
                            threshold: float = 0.5,
                            save_path: Optional[str] = None):
    """Histogram + sorted log plot of one sample's edge probabilities
    (visualize_wireframe.py:226-253)."""
    p = np.asarray(edge_probs).ravel()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
    ax1.hist(p, bins=50, color="tab:blue", alpha=0.8)
    ax1.axvline(threshold, color="tab:red", linestyle="--",
                label=f"threshold {threshold}")
    ax1.set_xlabel("edge probability"); ax1.set_ylabel("count")
    ax1.legend(); ax1.set_title("Edge probability histogram")
    ax2.plot(np.sort(p)[::-1])
    ax2.axhline(threshold, color="tab:red", linestyle="--")
    ax2.set_yscale("log"); ax2.set_xlabel("rank (sorted)")
    ax2.set_title("Sorted edge probabilities")
    return _maybe_save(fig, save_path)
