"""Matplotlib plots of clouds, wireframes and predictions (`viz.plots`).

Port of `wireframe_tpu/viz`.  matplotlib is imported by `viz.plots` only,
and this package imports `plots` when one of its functions is first
asked for, so `import wireframe_tpu_torch` (and every other module of
the port) runs where matplotlib is not installed, as on the card's
machine.
"""

_PLOTS = ("plot_point_cloud", "plot_wireframe", "plot_prediction_comparison",
          "plot_training_loss", "plot_edge_probabilities")

__all__ = list(_PLOTS)


def __getattr__(name):
    if name in _PLOTS:
        from wireframe_tpu_torch.viz import plots

        return getattr(plots, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
