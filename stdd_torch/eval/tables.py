"""LaTeX results tables from evaluation reports (reference
``dualrun/results/gen_tables.py``): reads ``report_<pool>.json`` files and
emits booktabs-style tables of clip/video metrics with per-technique columns.

The code of the JAX package's ``stdd_tpu/eval/tables.py``: it is pure Python.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional


def _fmt(x, digits=3) -> str:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return str(x)
    if v != v:  # nan
        return "--"
    return f"{v:.{digits}f}"


def report_table(reports: Dict[str, Dict], caption: str = "Evaluation results",
                 label: str = "tab:results") -> str:
    """One row per (run, pool) report: clip AUC/acc, video AUC/acc."""
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        rf"\caption{{{caption}}}",
        rf"\label{{{label}}}",
        r"\begin{tabular}{lcccc}",
        r"\toprule",
        r"Run & Clip AUC & Clip Acc & Video AUC & Video Acc \\",
        r"\midrule",
    ]
    for name, rep in sorted(reports.items()):
        c = rep.get("clip_metrics", {})
        v = rep.get("video_metrics", {})
        lines.append(
            f"{name.replace('_', r'\_')} & {_fmt(c.get('auc_roc'))} & "
            f"{_fmt(c.get('accuracy'))} & {_fmt(v.get('auc_roc'))} & "
            f"{_fmt(v.get('accuracy'))} \\\\"
        )
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def per_tech_table(report: Dict, caption: str = "Per-technique video accuracy",
                   label: str = "tab:per_tech") -> str:
    pt = report.get("per_tech_video_accuracy", {})
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        rf"\caption{{{caption}}}",
        rf"\label{{{label}}}",
        r"\begin{tabular}{lcc}",
        r"\toprule",
        r"Technique & Accuracy & Videos \\",
        r"\midrule",
    ]
    for tech, d in sorted(pt.items()):
        lines.append(
            f"{tech.replace('_', r'\_')} & {_fmt(d.get('accuracy'))} & "
            f"{d.get('videos', d.get('n', '--'))} \\\\"
        )
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def generate_tables(report_glob: str, out_path: Optional[str] = None) -> str:
    reports = {}
    for p in sorted(glob.glob(report_glob)):
        name = os.path.splitext(os.path.basename(p))[0]
        run = os.path.basename(os.path.dirname(p)) or name
        with open(p) as f:
            reports[f"{run}/{name}"] = json.load(f)
    parts = [report_table(reports)]
    for name, rep in sorted(reports.items()):
        if rep.get("per_tech_video_accuracy"):
            parts.append(per_tech_table(rep, caption=f"Per-technique — {name}"))
    tex = "\n\n".join(parts)
    if out_path:
        with open(out_path, "w") as f:
            f.write(tex)
    return tex
