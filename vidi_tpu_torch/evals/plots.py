"""Evaluation plots: per-attribute accuracy-threshold curves + radar charts
(a copy of vidi_tpu/evals/plots.py for the port).

Behavior-matched to the reference's visualization
(reference: VUE_TR_V2/qa_eval.py:21-102 draw_plot / radar_plot): same file
layout (output_dir/<attribute-family>/<attr>_<metric>_plot.png, overall also
as PDF, <metric>_radar_plot.png), same AUC-in-legend convention, sorted
ascending so the best method draws on top.

matplotlib with the Agg backend (host-side, no display).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Sequence

import numpy as np

_trapz = getattr(np, "trapezoid", None) or np.trapz

BASE_COLORS = [
    "blue", "red", "green", "orange", "cyan", "grey", "brown", "purple",
    "pink", "olive", "black", "indianred", "chocolate", "darkolivegreen",
    "gold", "darkcyan", "slategrey", "darkblue", "indigo", "deeppink",
    "sienna", "crimson", "darkseagreen", "dodgerblue", "navy", "violet",
    "tan", "teal",
]

_FAMILY = {
    **{a: "duration_category"
       for a in ("ultra-short", "short", "medium", "long", "ultra-long")},
    **{a: "query_format" for a in ("keyword", "phrase", "sentence")},
    **{a: "query_modality" for a in ("audio", "vision", "vision+audio")},
}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_plot(result_rates: Dict[str, np.ndarray], attribute: str,
              plot_name: str, output_dir: str = "") -> str:
    """One accuracy-vs-threshold curve per method; legend carries the AUC."""
    plt = _plt()
    sub = _FAMILY.get(attribute, "")
    output_path = osp.join(output_dir, sub) if sub else output_dir
    os.makedirs(output_path, exist_ok=True)

    thres = np.linspace(0, 1, 101)
    auc = {m: _trapz(r, thres) * 100 for m, r in result_rates.items()}
    colors = {m: BASE_COLORS[i % len(BASE_COLORS)]
              for i, m in enumerate(result_rates)}
    order = sorted(auc.items(), key=lambda x: x[1])  # worst first, best on top

    plt.figure(figsize=(10, 8))
    for m, _ in order:
        plt.plot(thres, result_rates[m], label=f"{m} [{auc[m]:.2f}%]",
                 linewidth=3, color=colors[m])
    plt.title(f"Accuracy-{plot_name} Plot for {attribute}", fontsize=30)
    plt.xlabel(f"{plot_name} Threshold", fontsize=24)
    plt.ylabel("Accuracy", fontsize=24)
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.xticks(np.arange(0, 1.1, 0.1))
    plt.yticks(np.arange(0, 1.1, 0.1))
    plt.tick_params(axis="both", which="major", labelsize=18)
    plt.grid(True)
    handles, labels = plt.gca().get_legend_handles_labels()
    plt.legend(handles[::-1], labels[::-1], loc="best", fontsize=24)
    out = osp.join(output_path, f"{attribute}_{plot_name}_plot.png")
    plt.savefig(out, dpi=300, bbox_inches="tight")
    if attribute == "overall":
        plt.savefig(osp.join(output_path, f"{attribute}_{plot_name}_plot.pdf"),
                    dpi=300, bbox_inches="tight")
    plt.close()
    return out


def radar_plot(attributes: Sequence[str], scores: Dict[str, np.ndarray],
               mode: str, output_dir: str = "") -> str:
    """Polar chart of per-attribute scores, one trace per method."""
    plt = _plt()
    os.makedirs(output_dir or ".", exist_ok=True)
    colors = {m: BASE_COLORS[i % len(BASE_COLORS)]
              for i, m in enumerate(scores)}
    n = len(attributes)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).tolist()
    angles += angles[:1]
    _, ax = plt.subplots(figsize=(10, 10), subplot_kw=dict(polar=True))
    for name, values in scores.items():
        vals = list(np.asarray(values)) + [np.asarray(values)[0]]
        ax.plot(angles, vals, label=name, linewidth=2, color=colors[name])
        ax.fill(angles, vals, alpha=0.2, color=colors[name])
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(attributes, fontsize=15)
    ax.set_rlabel_position(0)
    ax.yaxis.grid(True)
    ax.xaxis.grid(True)
    ax.tick_params(axis="y", labelsize=12)
    plt.title(mode + " Scores of Attributes", size=20, color="black", y=1.1)
    plt.legend(loc="upper right", bbox_to_anchor=(1.1, 0.1), fontsize=15)
    out = osp.join(output_dir, mode + "_radar_plot.png")
    plt.savefig(out, dpi=300, bbox_inches="tight")
    plt.close()
    return out
