"""Plotting / inspection: alignment & attention heatmaps, segmentations.

Counterpart of ``multimodalworddiscovery_tpu/utils/plotting.py``: host-side
matplotlib (Agg backend).  matplotlib is imported when a plot is drawn, not
with this module, and its absence is an error naming it (the CUDA host may
lack it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"plotting needs the 'matplotlib' package, which is not installed "
                          f"({e})") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, path):
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return None
    return fig


def plot_alignment_matrix(
    matrix: np.ndarray,
    src_labels: list[str] | None = None,
    trg_labels: list[str] | None = None,
    title: str = "alignment",
    path: str | Path | None = None,
):
    """Heatmap of an attention/posterior matrix [T_trg, T_src]."""
    plt = _pyplot()
    matrix = np.asarray(matrix)
    fig, ax = plt.subplots(figsize=(max(4, matrix.shape[1] * 0.3), max(3, matrix.shape[0] * 0.3)))
    im = ax.imshow(matrix, aspect="auto", cmap="viridis", interpolation="nearest")
    fig.colorbar(im, ax=ax, fraction=0.03)
    if src_labels is not None:
        ax.set_xticks(range(len(src_labels)), src_labels, rotation=90, fontsize=7)
    if trg_labels is not None:
        ax.set_yticks(range(len(trg_labels)), trg_labels, fontsize=7)
    ax.set_xlabel("source (phones/frames)")
    ax.set_ylabel("target (concepts)")
    ax.set_title(title)
    return _finish(plt, fig, path)


def plot_segmentation(
    alignment: np.ndarray,
    segments: list[tuple[int, int, int]],
    gold_segments: list[tuple[int, int, int]] | None = None,
    src_labels: list[str] | None = None,
    concept_names: list[str] | None = None,
    title: str = "segmentation",
    path: str | Path | None = None,
):
    """Bar view of predicted (and gold) word units over one utterance."""
    plt = _pyplot()
    length = len(alignment)
    rows = 2 if gold_segments is not None else 1
    fig, axes = plt.subplots(rows, 1, figsize=(max(6, length * 0.3), 1.2 * rows + 1),
                             squeeze=False)

    def draw(ax, segs, label):
        ax.set_xlim(0, length)
        ax.set_ylim(0, 1)
        ax.set_yticks([])
        ax.set_ylabel(label, rotation=0, ha="right", va="center")
        cmap = plt.get_cmap("tab20")
        for s, e, c in segs:
            ax.axvspan(s, e, color=cmap(c % 20), alpha=0.6)
            name = concept_names[c] if concept_names else str(c)
            ax.text((s + e) / 2, 0.5, name, ha="center", va="center", fontsize=7, rotation=90)

    draw(axes[0][0], segments, "pred")
    if gold_segments is not None:
        draw(axes[1][0], gold_segments, "gold")
    if src_labels is not None:
        axes[-1][0].set_xticks(np.arange(length) + 0.5, src_labels, rotation=90, fontsize=6)
    fig.suptitle(title)
    return _finish(plt, fig, path)


def plot_loglik_curve(logliks, title: str = "EM log-likelihood", path: str | Path | None = None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(np.asarray(logliks), marker="o", ms=3)
    ax.set_xlabel("iteration")
    ax.set_ylabel("log-likelihood")
    ax.set_title(title)
    return _finish(plt, fig, path)
