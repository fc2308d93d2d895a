"""Tabular metric reports: the port's own copy of
``mjvideo_tpu/eval/report.py``.

The reference dumps per-device Excel workbooks from its evaluate overrides
(``criteria_train.py:312-314``, ``overall_train.py:386-387``).  Here metric
rows (from ``eval.metrics``) go to CSV or XLSX through pandas, imported
only by ``metrics_to_dataframe`` and ``save_report``, and to a plain-text
table (``format_table``) that needs nothing beyond the standard library.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def metrics_to_dataframe(rows: List[Dict]):
    """``binary_dimension_metrics`` rows -> a pandas DataFrame."""
    import pandas as pd

    return pd.DataFrame(rows)


def save_report(
    rows: List[Dict], path: str, sheet_name: str = "metrics"
) -> str:
    """Write metric rows to .csv or .xlsx (by extension); without an Excel
    writer (openpyxl/xlsxwriter) the report goes to a CSV beside the
    requested path.  Returns the path written."""
    df = metrics_to_dataframe(rows)
    if path.endswith(".xlsx"):
        try:
            df.to_excel(path, sheet_name=sheet_name, index=False)
            return path
        except ImportError:
            path = path[: -len(".xlsx")] + ".csv"
    df.to_csv(path, index=False)
    return path


def format_table(rows: List[Dict], columns: Optional[List[str]] = None) -> str:
    """Plain-text table for logs and the console."""
    if not rows:
        return "(no rows)"
    columns = columns or list(rows[0].keys())
    widths = {
        c: max(len(str(c)), *(len(_fmt(r.get(c))) for r in rows))
        for c in columns
    }
    header = "  ".join(str(c).ljust(widths[c]) for c in columns)
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append("  ".join(_fmt(r.get(c)).ljust(widths[c])
                               for c in columns))
    return "\n".join(lines)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
