"""Per-fold result tables: a logged plain-text table and a CSV side file,
as the JAX package's ``metrics/report.py`` writes them (without pandas or
tabulate)."""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


def format_table(results: List[Dict]) -> str:
    """GitHub-style table of the rows, columns in order of first appearance."""
    cols = list(dict.fromkeys(k for r in results for k in r))
    cells = [[str(r.get(c, "")) for c in cols] for r in results]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)]

    def line(vals):
        return "| " + " | ".join(v.ljust(w) for v, w in zip(vals, widths)) + " |"

    return "\n".join([line(cols), "|" + "|".join("-" * (w + 2) for w in widths) + "|",
                      *(line(row) for row in cells)])


def summarize_folds(results: List[Dict], output_dir: str, logger,
                    name: str = "results") -> Optional[List[Dict]]:
    """Log the table and write ``<output_dir>/<name>.csv``; returns the rows."""
    if not results:
        logger.warning("no results to summarize")
        return None
    logger.info("\n%s", format_table(results))
    cols = list(dict.fromkeys(k for r in results for k in r))
    path = os.path.join(output_dir, f"{name}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols)
        writer.writeheader()
        writer.writerows(results)
    logger.info("wrote %s", path)
    return results
